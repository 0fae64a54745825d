"""Distribution: the reference's sharding rules over a ``DeviceMesh``
(``sharding``) and the sharded cache writes (``cache_update``)."""

import sys


def is_dtensor(x) -> bool:
    """True for a DTensor.  No DTensor exists before
    ``torch.distributed.tensor`` is imported, so a plain program never
    pays for that import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)
