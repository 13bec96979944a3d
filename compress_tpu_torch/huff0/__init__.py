"""huff0 helpers of the port (pure-Python table serialization)."""
