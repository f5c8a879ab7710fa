"""Seed extraction."""
