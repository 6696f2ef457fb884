"""Encoder, LSTM cell and the adaptive-attention decoder."""
