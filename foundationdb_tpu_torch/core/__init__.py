"""Port configuration (knobs)."""
