"""Sketching: the native file-driver route."""
