"""Utilities: step clocks, the rlog TSV logger, tracing and memory reports."""
