"""Launchers of the port: the serving loop and its step factories."""
