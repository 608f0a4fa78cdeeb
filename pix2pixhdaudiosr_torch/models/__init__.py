"""Generator networks of the port."""
