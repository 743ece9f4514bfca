"""One rank of the two-process landmark-sharded BA of
tests/test_torch_dist_ba.py: `dist_bundle_adjust` over a `ProcessMesh` of
a gloo group, on the problem the test saved. Imports torch and the port
only.

    python tests/_torch_dist_ba_worker.py PORT RANK WORLD PROBLEM.npz OUT.npz

Every rank loads the same problem; rank 0 writes the result. JAX and the
JAX package are blocked here (an import of either fails), as on a machine
with a card.
"""
import os
import sys

sys.modules["jax"] = None
sys.modules["orbslam3lib_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam3lib_tpu_torch.mapping.local_ba import BAProblem  # noqa: E402
from orbslam3lib_tpu_torch.parallel.dist_ba import (ProcessMesh,  # noqa: E402
                                                    dist_bundle_adjust)


def main() -> int:
    port, rank, world, src, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        z = np.load(src)
        prob = BAProblem(*(torch.from_numpy(z[f]) for f in BAProblem._fields))
        R, t, pts, inl = dist_bundle_adjust(prob, torch.from_numpy(z["cam_params"]),
                                            ProcessMesh(), n_iters=int(z["n_iters"]))
        if rank == 0:
            np.savez(out, R=R.numpy(), t=t.numpy(), pts=pts.numpy(), inl=inl.numpy())
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
