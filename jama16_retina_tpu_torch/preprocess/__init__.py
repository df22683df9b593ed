"""Host-side photograph preprocessing of the port."""
