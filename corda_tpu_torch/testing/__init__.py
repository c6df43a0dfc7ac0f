"""On-hardware checks for the port."""
