"""Operator surface: only the options the disruption controller reads."""
