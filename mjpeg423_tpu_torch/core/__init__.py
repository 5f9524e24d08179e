"""Container format and constant tables (host, NumPy)."""
