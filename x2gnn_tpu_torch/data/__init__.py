"""Host-side graph construction and batching (numpy)."""
