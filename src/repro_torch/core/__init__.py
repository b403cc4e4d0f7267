"""Core FedPart library, ported: partitions, masks, schedules, aggregation
and the cost books (``repro.core``'s counterparts)."""
