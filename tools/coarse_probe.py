"""Probe a larger coarse dimension on device (chunked inverse path)."""
import sys, time
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp
import fcvm_tpu
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector
from fcvm_tpu.config import get_config, enable_compilation_cache
enable_compilation_cache()

cs = int(sys.argv[1]) if len(sys.argv) > 1 else 163
get_config().coarse_max_dim = 50000  # let the probe exceed the default cap
dtype = jnp.float32
mesh = meshgen.box_tet10(27, 27, 27, 10.0, 10.0, 10.0)
coords = jnp.asarray(mesh.coords, dtype)
eln = jnp.asarray(mesh.elnodes)
dmat = mat.hooke_dmat(jnp.asarray(210000.0, dtype), jnp.asarray(0.3, dtype))
bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
    (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
    (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
    (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
])
faces = mesh.faces_on(lambda x, y, z: x > 10.0 - 1e-9)
lt = sysm.LoadTables.from_spec(
    fcvm_tpu.Loads(traction_faces=faces,
                   tractions=np.tile([100.0, 0, 0], (len(faces), 1))), dtype)
fm_np, uf_np, _ = bcs.masks(mesh.ndof)
nd = pad_ndof(mesh.ndof)
fm = jnp.asarray(pad_vector(fm_np, nd), dtype)
uf = jnp.asarray(pad_vector(uf_np, nd), dtype)
plan = asm.build_scatter_plan(mesh.elnodes, nd // 3)
space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fm, nd)
esm, pinv, glv, rhs, *_ = jax.block_until_ready(
    sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype), fm, uf, plan))
print("assembled", flush=True)
t0 = time.perf_counter()
pc = jax.block_until_ready(sysm.build_precond(esm, eln, coords, fm, cs, space=space))
print(f"build cs={cs} dim={pc.coarse_inv.shape[0]}: {time.perf_counter()-t0:.1f}s", flush=True)
res = jax.block_until_ready(sysm.solve_displacement(esm, eln, fm, pc, rhs, 1e-5, 5000, plan=plan, space=space))
t0 = time.perf_counter()
res = jax.block_until_ready(sysm.solve_displacement(esm, eln, fm, pc, rhs, 1e-5, 5000, plan=plan, space=space))
dt = time.perf_counter() - t0
print(f"solve: {int(res.iters)} iters relres {float(res.relres):.2e} "
      f"{dt*1e3:.0f} ms ({dt/max(int(res.iters),1)*1e3:.2f} ms/iter)", flush=True)
