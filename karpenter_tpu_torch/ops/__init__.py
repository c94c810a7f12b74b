"""Small tensor helpers shared by the port's models."""
