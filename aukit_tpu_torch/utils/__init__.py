"""Small host helpers shared by the whole-file surface."""
