"""Data helpers of the training path."""
