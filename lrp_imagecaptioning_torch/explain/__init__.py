"""Decoder-side and CNN-side LRP."""
