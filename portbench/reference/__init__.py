"""Plain references and the comparisons that decide ``correct``."""
