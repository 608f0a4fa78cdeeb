"""Signal and kernel ops of the port."""
