"""Blocked segmented windowed scan of the window engine."""
