"""Hash-join build/probe engine (build tables, probe, emit lookup)."""
