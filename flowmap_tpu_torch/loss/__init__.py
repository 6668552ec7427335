"""Losses: `loss.py` (flow loss, compute_losses) and `mapping.py`.

Import from the submodules: `ops/kernels/flow_loss.py` depends on
`mapping.py`, so this package does not import `loss.py` eagerly.
"""
