"""Host-side graph data of the port."""
