"""FlowMap's per-scene optimisation in PyTorch, with hand-written Hopper kernels.

The package mirrors `flowmap_tpu`'s layout and names (`types`, `ops`, `loss`,
`model`, `training`, `utils`) so each module has an obvious counterpart. It
imports `torch` and numpy only. Entry points default to `device="cuda"`; on a
machine without a card they raise unless the caller passes `device="cpu"`.
"""
