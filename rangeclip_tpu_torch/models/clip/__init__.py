"""Text-embedding providers."""
