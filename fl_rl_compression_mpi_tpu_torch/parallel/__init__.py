"""Distribution over a ``torch.distributed`` process group (``dist.py``)."""
