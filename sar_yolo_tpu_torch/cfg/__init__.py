"""Model configurations shipped as Python dicts."""
