"""One rank of the port's quantized ring all-reduce over gloo (a helper of
``test_torch_optim.py``, run in spawned processes; imports no JAX)."""
import numpy as np
import torch
import torch.distributed as dist


def ring_rank(rank: int, world: int, port: int, path: str):
    """Rank ``rank`` of ``world``: quantized_psum of its row of the inputs
    in ``path`` (an npz of x and residual, (world, N) each); returns (sum,
    new residual) as numpy."""
    from repro_torch.optim import quantized_psum
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        with np.load(path) as d:
            x, res = d["x"][rank], d["residual"][rank]
        out, err = quantized_psum(torch.from_numpy(x),
                                  residual=torch.from_numpy(res))
        return out.numpy(), err.numpy()
    finally:
        dist.destroy_process_group()
