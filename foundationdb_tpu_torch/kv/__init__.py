"""Keys and key ranges."""
