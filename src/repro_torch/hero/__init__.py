"""Deployable artifacts and the serve engine."""
