"""Measurement tools for the port; each runs on the card."""
