"""Utilities of the port: metrics logging, host-device copies."""
