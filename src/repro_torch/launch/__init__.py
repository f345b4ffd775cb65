"""Launchers of the port: the single-device training launcher."""
