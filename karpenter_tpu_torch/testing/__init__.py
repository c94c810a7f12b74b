"""Snapshot builders of the port, and the carry-over of a reference snapshot."""
