"""Logging and statistics helpers of the port."""
