"""Device and math helpers."""
