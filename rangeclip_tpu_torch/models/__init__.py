"""Network modules and model wrappers."""
