"""Small shared tables."""
