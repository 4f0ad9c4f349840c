"""Host-side node ordering for locality."""
