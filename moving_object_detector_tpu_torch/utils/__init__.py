"""Weight loading."""
