"""Diagnostic renders of the port: test videos and mesh videos."""
