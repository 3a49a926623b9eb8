"""H-EYE on PyTorch and CUDA: the port of the ``repro`` package.

Runs on the CUDA device unless the caller passes ``device="cpu"`` (see
``repro_torch.device``).  Imports ``torch`` and ``numpy`` only."""
