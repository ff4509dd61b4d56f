"""Step builders for serving (prefill and decode)."""
