"""Command-line side tools of the port (numpy only)."""
