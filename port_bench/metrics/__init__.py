"""One reader a per-layer metric, in the file named after it: read(ctx) ->
the value, or None where the trace holds nothing to read."""
