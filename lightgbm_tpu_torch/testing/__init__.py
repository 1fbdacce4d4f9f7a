"""Seeded synthetic models and rows for the card and the tests."""
