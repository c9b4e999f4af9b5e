"""Host-side communication between processes (one process until A13)."""
