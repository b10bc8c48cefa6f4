"""The port's batching plane: a warm model session with a padded batch
ladder (``session``) driven by the continuous batcher (``scheduler``),
with its request types (``batcher``) and metrics (``metrics``). The
streaming polish runs on it; the HTTP service is not ported yet."""
