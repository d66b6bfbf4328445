"""Stable jobs of the port: named training runs with acceptance criteria."""
