"""The table→tensor data pipeline of the port (reference ``data/``)."""
