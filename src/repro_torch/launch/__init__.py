"""Launchable jobs of the port."""
