"""FSE helpers of the port (pure-Python copies of what frame assembly needs)."""
