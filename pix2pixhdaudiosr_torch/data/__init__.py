"""Audio file I/O and the test dataset of the port."""
