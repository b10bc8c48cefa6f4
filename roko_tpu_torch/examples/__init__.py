"""End-to-end walkthroughs of the port on simulated data (counterparts of
the reference's ``examples/``): sim -> features -> train -> inference ->
assess, with no download.

- :mod:`roko_tpu_torch.examples.synthetic_e2e`: one 12 kb genome, the
  draft's error rate beside the polished one's, in the uniform or the
  homopolymer error regime;
- :mod:`roko_tpu_torch.examples.multispecies_protocol`: five training
  species, one validation species for early stopping, one held-out test
  species.

Run either with ``python -m roko_tpu_torch.examples.<name>``; both take
``--device {cuda,cpu}`` (default cuda: without a card, pass ``--device
cpu``).
"""
