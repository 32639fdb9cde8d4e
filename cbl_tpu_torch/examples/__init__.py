"""Examples of the port, twins of `examples/` of `cbl_tpu`: each runs as
`python -m cbl_tpu_torch.examples.<name> ... [--device cpu]` from the
repository root, on the card by default."""
