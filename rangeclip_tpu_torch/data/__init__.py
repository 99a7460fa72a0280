"""Host-side (numpy) label and depth helpers."""
