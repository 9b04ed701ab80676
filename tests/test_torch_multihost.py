"""Multi-process smoke test of the port's parallel/mesh.init_distributed, the
counterpart of tests/test_multihost.py: two OS processes (``python -c``) join
one world through a rendezvous file, build a one-axis mesh over it and sum
over it. The CPU and gloo; no JAX in the processes.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = """
import sys, torch
from visual_odometry_tpu_torch.parallel import mesh
address, n, i = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
world = mesh.init_distributed(address, num_processes=n, process_id=i)
m = mesh.single_axis_mesh(name="lm", device="cpu")
total = mesh.psum(m, torch.tensor([float(i + 1)]), "lm")
assert world == n and m.shape == {"lm": n} and m.axis_index("lm") == i
assert float(total) == n * (n + 1) / 2, total
print(f"MULTIHOST OK process={i} world={world} psum={float(total)}")
torch.distributed.destroy_process_group()
"""


def test_two_process_distributed_psum(tmp_path):
    address = "file://" + str(tmp_path / "rendezvous")
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", _PROGRAM, address, "2", str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    combined = "\n".join(outs)
    assert all(p.returncode == 0 for p in procs), combined[-2000:]
    assert combined.count("MULTIHOST OK") == 2, combined[-2000:]
