"""Compositions of table and array operators (reference ``apps/``)."""
