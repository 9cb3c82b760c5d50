"""Logical-axis sharding rules and their DTensor placements (the port of
``repro.distributed``)."""
