"""Timing helpers for the card."""
