"""Launchers: the host mesh and the training launcher."""
