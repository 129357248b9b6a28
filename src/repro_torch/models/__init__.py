"""Model layers and the LM stack."""
