"""The port's polishing service (``roko_tpu/serve``, single-process
form): a warm model session with a padded batch ladder and its ragged
step (``session``), the deadline batcher and the request types
(``batcher``), the continuous and ragged batchers (``scheduler``),
metrics (``metrics``), the HTTP front end (``server``) and its client
(``client``). The streaming polish rides the same continuous batcher.
The fleet, its supervisor, registry and rollout are queue item A9.5.

The names are imported from their modules (``roko_tpu_torch.serve.
server.make_server``, ...): this package imports nothing itself, so the
host-side batchers load without torch."""
