"""Serving entry points of the LM stack."""
