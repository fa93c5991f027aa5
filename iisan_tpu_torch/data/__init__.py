"""Corpora for the port: synthetic interaction data."""
