"""Shuffle destination compute: murmur hashes, ``h1 % P`` and histogram."""
