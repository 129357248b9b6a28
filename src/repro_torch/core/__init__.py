"""Serve-side model API."""
