"""The meshed pack: the slot axis of the grouped pack scan split into the
shards of a mesh (`sharded.py`)."""
