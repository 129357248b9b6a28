"""Noise, probe keys, the ZO update engine and the model API."""
