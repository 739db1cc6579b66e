"""Share of the served blocks that landed by DMA straight from the caller's registered memory, %: 100 × the `direct` count of the program's `afp.serve.land` spans per block returned (0 where every block was staged; nothing to read from a program without direct landing, `afp_tpu_torch.utils.staging.land`)."""
from perfbench.harness import program


def _lands_directly() -> bool:
    try:
        from afp_tpu_torch.utils import staging
    except ImportError:
        return False
    return hasattr(staging, "land")


def read(trace):
    if not _lands_directly():
        return None
    n = program.count_per_block(trace, "direct", ("afp.serve.land",))
    return None if n is None else 100.0 * n
