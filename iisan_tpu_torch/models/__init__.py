"""Torch modules of the port: layers, user encoder, SAN, recommender."""
