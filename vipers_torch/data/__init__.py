"""Preprocessing constants, shape rules and box IoU."""
