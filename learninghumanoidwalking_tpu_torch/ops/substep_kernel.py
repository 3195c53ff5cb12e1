"""Kernels K1 (flat floor), K2 (terrain boxes), K3 (heightfield), K4
(learned motor hook, flat floor), K5 (terrain boxes and the motor hook) and
K6 (heightfield and the motor hook): the wrapper over
csrc/control_step_lanes.cu.

Replaces the Pallas TPU kernel of learninghumanoidwalking_tpu/ops/
substep_kernel.py (``make_control_step``, its ``pl.pallas_call``). One
launch runs all ``frame_skip`` PD + physics substeps of every env, on a
group of lanes per env with its working set in shared memory and the Pallas
kernel's Woodbury contact solve, launched by ``launch_plan``. Four
libraries built from that one source: "flat" (K1: 8 contact slots, the
factorization reused over groups of R substeps), "terrain" (K2 and K3: 16
contact slots, a slot-kind table, per-env terrain inputs staged in shared
memory, R=1), "motor" (K4: the flat floor at R=1 plus the motor hook,
its histories and count in and out) and "terrain_motor" (K5 and K6: the
terrain build plus the motor hook).

``pd_substeps_kernel`` has the signature of the plain version,
physics/batched.py::pd_substeps_batched, and returns the same
PhysicsState (with a motor: PhysicsState and MotorState):

* tensors on the CPU take the plain version;
* tensors on a CUDA device launch the kernel, or raise. Nothing falls back.

The model reaches the kernel as runtime tables in device memory (topology,
offsets, inertias, actuators, contact slots and their kinds), built once
per model and device and cached by the model's CONTENT, in the table layout
that the built library reports (caps and offsets live only in the CUDA
sources). Motor weights are uploaded the same way, once per content and
device.
"""

from __future__ import annotations

import ctypes
import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.ops import build
from learninghumanoidwalking_tpu_torch.physics import engine as eng
from learninghumanoidwalking_tpu_torch.physics.batched import PROJ_REFINE_ITERS, pd_substeps_batched, valid_reuse
from learninghumanoidwalking_tpu_torch.physics.engine import Terrain, _tables
from learninghumanoidwalking_tpu_torch.physics.model import FREE, HINGE, SLIDE, Contact, DynParams, Model, PhysicsState
from learninghumanoidwalking_tpu_torch.physics.spec import _quat_to_mat_np
from learninghumanoidwalking_tpu_torch.robots.motor import HIST_LEN, MotorState
from learninghumanoidwalking_tpu_torch.utils import trace

# build name, sources and preprocessor defines of each library; K2 and K3
# share "terrain", K5 and K6 "terrain_motor"
LIBRARIES = {
    "flat": ("lhw_control_step_flat", ("control_step_lanes.cu",), ("-DLHW_TERRAIN=0",)),
    "terrain": ("lhw_control_step_terrain", ("control_step_lanes.cu",), ()),
    "motor": ("lhw_control_step_motor", ("control_step_lanes.cu",), ("-DLHW_TERRAIN=0", "-DLHW_MOTOR=1")),
    "terrain_motor": ("lhw_control_step_terrain_motor", ("control_step_lanes.cu",), ("-DLHW_TERRAIN=1", "-DLHW_MOTOR=1")),
}
# the library each kernel runs from
LIBRARY_OF = {"K1": "flat", "K2": "terrain", "K3": "terrain", "K4": "motor", "K5": "terrain_motor", "K6": "terrain_motor"}


class LaunchCounter:
    """Launches of a kernel (not of its plain version), for showing that a
    run went through it."""

    def __init__(self) -> None:
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


counters = {name: LaunchCounter() for name in LIBRARY_OF}


def variant(model: Model, hfield: bool, motor: bool = False) -> str:
    """Which kernel runs ``model``: K2 with terrain boxes, K3 with a
    heightfield and no boxes, K1 on the flat floor; with a motor model K5,
    K6 and K4 in their places."""
    if model.nterrain > 0:
        return "K5" if motor else "K2"
    if hfield:
        return "K6" if motor else "K3"
    return "K4" if motor else "K1"


def motor_dims(params: dict) -> list[int]:
    """Layer widths of stacked motor-net params: [d_in, hidden..., d_out]."""
    n_layers = int(params["n_layers"])
    return [int(params["w0"].shape[1])] + [int(params[f"w{li}"].shape[2]) for li in range(n_layers)]


def check_model(model: Model, lay: dict, hfield_shape: tuple | None = None, motor: dict | None = None) -> None:
    """Raise unless the library of table layout ``lay`` runs ``model`` (with
    a heightfield of ``hfield_shape`` (H, W) if given, and the motor-net
    params ``motor`` if given): within its caps, on terrain only in a
    terrain build, with a motor model only in a motor build (on the flat
    floor the motor build, K4; on terrain the terrain + motor build, K5 and
    K6)."""
    fb = {model.geom_body[g] for g in model.foot_geoms}
    problems = []
    on_terrain = bool(model.nterrain) or hfield_shape is not None
    if motor is not None:
        if on_terrain and not (lay["LHW_TERRAIN"] and lay.get("LHW_MOTOR")):
            problems.append("a motor model on terrain needs the terrain + motor build (K5, K6)")
        if not lay.get("LHW_MOTOR"):
            problems.append("motor models need a motor build (K4 on the flat floor, K5 or K6 on terrain)")
        else:
            dims, nu = motor_dims(motor), model.nu
            shapes_ok = all(
                tuple(motor[f"w{li}"].shape) == (nu, dims[li], dims[li + 1])
                and tuple(motor[f"b{li}"].shape) == (nu, dims[li + 1])
                for li in range(len(dims) - 1)
            ) and tuple(motor["skip"].shape) == (nu,)
            if not shapes_ok or dims[0] != 2 * lay["MAX_H"] or dims[-1] != 1:
                problems.append(f"motor nets {dims} do not take 2 x {lay['MAX_H']} history inputs to 1 output for {nu} joints")
            if len(dims) - 1 > lay["MAX_LAYERS"] or max(dims[1:-1], default=0) > lay["MAX_HID"]:
                problems.append(f"motor nets {dims} exceed {lay['MAX_LAYERS']} layers of width {lay['MAX_HID']}")
            elif "W_MTAU" in lay and nu * net_window_floats(dims) > lay["W_MTAU"]:
                problems.append(f"motor nets {dims}: {nu} joints' windows exceed the terrain + motor build's "
                                f"{lay['W_MTAU']} floats of scratch")
    if on_terrain and not lay["LHW_TERRAIN"]:
        problems.append("terrain and heightfield models need the terrain build (K2, K3)")
    if model.nterrain > lay["MAX_T"]:
        problems.append(f"{model.nterrain} terrain boxes exceed the cap {lay['MAX_T']}")
    if hfield_shape is not None and (min(hfield_shape) < 2 or hfield_shape[0] * hfield_shape[1] > lay["MAX_HF"]):
        problems.append(f"heightfield {hfield_shape} outside 2x2 .. {lay['MAX_HF']} nodes")
    if model.nbody > lay["MAX_B"] or model.nv > lay["MAX_V"] or model.nq > lay["MAX_Q"] or model.nu > lay["MAX_U"]:
        problems.append(f"sizes nb={model.nbody} nv={model.nv} nq={model.nq} nu={model.nu} exceed caps")
    if model.ncon > lay["MAX_C"] or len(fb) > lay["MAX_F"]:
        problems.append(f"{model.ncon} contact slots on {len(fb)} bodies exceed caps {lay['MAX_C']}/{lay['MAX_F']}")
    if any(model.body_parent[i] >= i for i in range(1, model.nbody)):
        problems.append("every body must follow its parent")
    if problems:
        raise ValueError("control-step kernel cannot run this model: " + "; ".join(problems))


def net_window_floats(dims: list[int]) -> int:
    """Floats of one joint's window in the terrain + motor build's scratch
    union (csrc net_window_ld): its inputs, or a wider hidden layer written
    over them; even."""
    w = max(dims[:-1])
    return w + w % 2


def slot_kinds(model: Model, hfield: bool) -> list[str]:
    """Kind of every contact slot, in slot order (the Pallas kernel's slot
    kinds, learninghumanoidwalking_tpu/ops/substep_kernel.py:180-209): per
    foot geom 4 corners vs the floor ("flat" z=0 plane without terrain,
    "floor" plane at floor_z, or "hfield" surface), then with terrain boxes
    the same 4 corners vs the box SDF ("box")."""
    floor_kind = "hfield" if hfield else ("floor" if model.nterrain > 0 else "flat")
    per_geom = [floor_kind] * 4 + (["box"] * 4 if model.nterrain > 0 else [])
    return per_geom * len(model.foot_geoms)


def build_tables(model: Model, lay: dict, hfield_shape: tuple | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(float table, int table) encoding ``model`` for the kernel, in the
    library's table layout ``lay``."""
    check_model(model, lay, hfield_shape)
    t = _tables(model)
    ft = np.zeros(lay["N_FTAB"], np.float32)
    it = np.zeros(lay["N_ITAB"], np.int32)
    nb, nv, nu, nc = model.nbody, model.nv, model.nu, model.ncon
    foot_bodies = []
    for gi in model.foot_geoms:
        if model.geom_body[gi] not in foot_bodies:
            foot_bodies.append(model.geom_body[gi])
    counts = (nb, nv, model.nq, nu, nc, len(foot_bodies), model.nterrain)
    for key, val in zip(("I_NB", "I_NV", "I_NQ", "I_NU", "I_NC", "I_NFOOT", "I_NT"), counts):
        it[lay[key]] = val
    it[lay["I_PARENT"] : lay["I_PARENT"] + nb] = model.body_parent
    it[lay["I_JTYPE"] : lay["I_JTYPE"] + nb] = model.jnt_type
    it[lay["I_QADR"] : lay["I_QADR"] + nb] = model.body_qpos_adr
    it[lay["I_DADR"] : lay["I_DADR"] + nb] = model.body_dof_adr
    it[lay["I_DNUM"] : lay["I_DNUM"] + nb] = model.body_dof_num
    it[lay["I_DOFBODY"] : lay["I_DOFBODY"] + nv] = model.dof_body
    act_of_dof = np.full(nv, -1, np.int32)
    for a, d in enumerate(model.actuator_dof):
        act_of_dof[d] = a
    it[lay["I_ACTOFDOF"] : lay["I_ACTOFDOF"] + nv] = act_of_dof
    for d in range(nv):
        bi = model.dof_body[d]
        jt = model.jnt_type[bi]
        k = d - model.body_dof_adr[bi]
        kind = {FREE: "DOF_FREE_LIN" if k < 3 else "DOF_FREE_ANG", HINGE: "DOF_HINGE", SLIDE: "DOF_SLIDE"}[jt]
        it[lay["I_DOFKIND"] + d] = lay[kind]
        it[lay["I_DOFK"] + d] = k % 3 if jt == FREE else 0
    it[lay["I_ACTQ"] : lay["I_ACTQ"] + nu] = model.actuator_qpos
    it[lay["I_ACTD"] : lay["I_ACTD"] + nu] = model.actuator_dof
    it[lay["I_FOOTBODY"] : lay["I_FOOTBODY"] + len(foot_bodies)] = foot_bodies
    anc = np.zeros((lay["MAX_B"], lay["MAX_V"]), np.int32)
    anc[:nb, :nv] = t["anc"] > 0.5
    it[lay["I_ANC"] : lay["I_ANC"] + anc.size] = anc.reshape(-1)

    h = model.host
    imp_min, imp_max = float(h["imp_min"]), float(h["imp_max"])
    timeconst, dampratio = float(h["timeconst"]), float(h["dampratio"])
    ft[lay["F_GRAV"] : lay["F_GRAV"] + 3] = h["gravity"]
    ft[lay["F_IMPMIN"]] = imp_min
    ft[lay["F_IMPDIFF"]] = imp_max - imp_min
    ft[lay["F_WIDTH"]] = float(h["imp_width"])
    ft[lay["F_KREF"]] = 1.0 / max(imp_max**2 * timeconst**2 * dampratio**2, 1e-12)
    ft[lay["F_BREF"]] = 2.0 / max(imp_max * timeconst, 1e-12)
    ft[lay["F_BPOS"] : lay["F_BPOS"] + 3 * nb] = h["body_pos"].reshape(-1)
    ft[lay["F_BQUAT"] : lay["F_BQUAT"] + 4 * nb] = h["body_quat"].reshape(-1)
    ft[lay["F_JAXIS"] : lay["F_JAXIS"] + 3 * nb] = h["jnt_axis"].reshape(-1)
    ft[lay["F_JPOS"] : lay["F_JPOS"] + 3 * nb] = h["jnt_pos"].reshape(-1)
    ft[lay["F_BINER"] : lay["F_BINER"] + 3 * nb] = h["body_inertia"].reshape(-1)
    iq = np.stack([_quat_to_mat_np(q) for q in h["body_iquat"]]).astype(np.float32)
    ft[lay["F_IQMAT"] : lay["F_IQMAT"] + 9 * nb] = iq.reshape(-1)
    ft[lay["F_BMASS0"] : lay["F_BMASS0"] + nb] = np.maximum(h["body_mass"], np.float32(1e-9))
    ft[lay["F_ARM"] : lay["F_ARM"] + nv] = h["dof_armature"]
    ft[lay["F_GEAR"] : lay["F_GEAR"] + nu] = h["actuator_gear"]
    ft[lay["F_CLO"] : lay["F_CLO"] + nu] = h["actuator_ctrlrange"][:, 0]
    ft[lay["F_CHI"] : lay["F_CHI"] + nu] = h["actuator_ctrlrange"][:, 1]
    kinds = slot_kinds(model, hfield_shape is not None)
    corners = np.tile(eng._BOTTOM_CORNERS, (eng.slots_per_geom(model) // 4, 1))
    slot = 0
    for gi in model.foot_geoms:
        grot = _quat_to_mat_np(h["geom_quat"][gi]).astype(np.float32)
        for corner in corners:
            it[lay["I_SLOTFOOT"] + slot] = foot_bodies.index(model.geom_body[gi])
            it[lay["I_SLOTKIND"] + slot] = lay["SLOT_" + kinds[slot].upper()]
            ft[lay["F_SGPOS"] + 3 * slot : lay["F_SGPOS"] + 3 * slot + 3] = h["geom_pos"][gi]
            ft[lay["F_SGROT"] + 9 * slot : lay["F_SGROT"] + 9 * slot + 9] = grot.reshape(-1)
            ft[lay["F_SCORN"] + 3 * slot : lay["F_SCORN"] + 3 * slot + 3] = corner * h["geom_size"][gi]
            ft[lay["F_MU"] + slot] = h["geom_friction"][gi]
            slot += 1
    boxes = [c for c, k in enumerate(kinds) if k == "box"]
    it[lay["I_NBOX"]] = len(boxes)
    it[lay["I_BOXSLOT"] : lay["I_BOXSLOT"] + len(boxes)] = boxes
    banc, levels, order = tree_tables(model)
    it[lay["I_BANC"] : lay["I_BANC"] + nb] = banc
    it[lay["I_NLEV"]] = len(levels) - 1
    it[lay["I_LEVEL"] : lay["I_LEVEL"] + len(levels)] = levels
    it[lay["I_BORDER"] : lay["I_BORDER"] + len(order)] = order
    return ft, it


def tree_tables(model: Model) -> tuple[list[int], list[int], list[int]]:
    """The kernels' tree tables: per body the bit mask of its
    ancestors and itself; bodies 1..nb-1 in order of depth, and where each
    depth starts in that order (depth d + 1 at levels[d], levels[-1] = nb - 1),
    so that a level's bodies depend only on earlier levels."""
    nb = model.nbody
    depth, banc = [0] * nb, [1] + [0] * (nb - 1)
    for i in range(1, nb):
        depth[i] = depth[model.body_parent[i]] + 1
        banc[i] = banc[model.body_parent[i]] | (1 << i)
    order = sorted(range(1, nb), key=lambda i: (depth[i], i))
    levels = [sum(depth[i] <= lv for i in range(1, nb)) for lv in range(max(depth) + 1)]
    return banc, levels, order


_DEVICE_TABLES: dict = {}


def device_tables(model: Model, device: torch.device, lay: dict, hfield_shape=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's tables in device memory, uploaded once per (content, device)."""
    ft, it = build_tables(model, lay, hfield_shape)
    key = (hashlib.sha256(ft.tobytes() + it.tobytes()).hexdigest(), str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = (
            torch.as_tensor(ft, device=device),
            torch.as_tensor(it, device=device),
        )
    return _DEVICE_TABLES[key]


# H100 shared memory: an SM's 228 KB, the most one block may use (227 KB),
# and what the runtime keeps of it per block
SMEM_SM, SMEM_BLOCK, SMEM_RESERVED = 233472, 232448, 1024
# blocks an SM that launch_plan leaves room for, in every library (fastest
# for K2-K4 and within 2% of the fastest for K1 in a sweep of 1-4 on the
# H100, ops/lane_sweep.py, PERF.md)
BLOCKS_PER_SM = 2


def terrain_floats(model: Model, hfield_shape: tuple | None = None) -> int:
    """Floats of one env's terrain as the terrain build stages it: per box
    its position, half-size, cos and sin of the yaw (8); a heightfield's
    H W nodes, origin and spacing (4); floor_z."""
    hw = hfield_shape[0] * hfield_shape[1] if hfield_shape else 0
    return 8 * model.nterrain + (hw + 4 if hw else 0) + 1


def launch_plan(model: Model, batch: int, lay: dict, hfield_shape: tuple | None = None) -> dict:
    """How the library of layout ``lay`` launches ``batch`` envs: a group of
    ``lanes`` (LHW_G) threads an env; ``envs_per_block`` envs a block, as
    many as leave BLOCKS_PER_SM blocks an SM room in shared memory
    (at most LHW_TPB threads; in the terrain + motor build at most NET_ENVS,
    and ``threads`` rounded up to whole warps, whose groups past the block's
    envs only meet the motor nets' barriers); each env's region of
    ``env_floats`` floats (its fixed part SM_FIXED, which holds the lagged
    basis on the flat floor and the motor histories in the motor build, K4,
    and on terrain its terrain;
    even, for its float64 arrays, and not a multiple of 32, so that the envs
    of a warp start in different banks); ``smem_bytes`` of dynamic shared
    memory a block beside ``static_bytes`` of tables; ``grid`` blocks, the
    last one ragged (block k runs envs k * envs_per_block + group). Raises
    where the model is past the build's caps or one env's region and the
    tables exceed the SMEM_BLOCK bytes a block may use."""
    check_model(model, lay, hfield_shape)
    lanes = lay["LHW_G"]
    stride = lay["SM_FIXED"] + (terrain_floats(model, hfield_shape) if lay["LHW_TERRAIN"] else 0)
    stride += stride % 2
    stride += 2 * (stride % 32 == 0)
    static, env_bytes = 4 * (lay["N_FTAB"] + lay["N_ITAB"]), 4 * stride
    if static + env_bytes > SMEM_BLOCK:
        raise ValueError(f"one env's shared region ({env_bytes} B) and the tables ({static} B) exceed {SMEM_BLOCK} B a block")
    budget = SMEM_SM // BLOCKS_PER_SM - SMEM_RESERVED
    epb = max(1, min(lay["LHW_TPB"] // lanes, lay.get("NET_ENVS", batch), (budget - static) // env_bytes, batch))
    threads = epb * lanes
    if "NET_ENVS" in lay:
        threads = -(-threads // 32) * 32
    return dict(lanes=lanes, envs_per_block=epb, threads=threads, env_floats=stride, smem_bytes=epb * env_bytes,
                static_bytes=static, grid=-(-batch // epb))


def motor_weights(params: dict, device: torch.device) -> torch.Tensor:
    """The stacked motor-net params as one contiguous float32 block on
    ``device``, in the kernel's order: per layer w then b, then skip. Packed
    on the device at every launch (130.7 KB for JVRC's 50-32-32-1 nets), so
    it needs no cache and no host synchronization."""
    tensors = [params[f"{k}{li}"] for li in range(int(params["n_layers"])) for k in ("w", "b")] + [params["skip"]]
    return torch.cat([t.to(device=device, dtype=torch.float32).reshape(-1) for t in tensors])


_LIBS: dict = {}


def _library(build_name: str) -> tuple[ctypes.CDLL, dict]:
    """Build (first use) and load library ``build_name`` (a key of
    LIBRARIES); (library, its table layout)."""
    if build_name not in _LIBS:
        path, _ = build.build_library(*LIBRARIES[build_name])
        lib = build.load_library(path)
        lib.lhw_control_step_layout.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.lhw_control_step_layout.restype = ctypes.c_int
        cap = 128
        names, values = (ctypes.c_char_p * cap)(), (ctypes.c_int * cap)()
        n = lib.lhw_control_step_layout(names, values, cap)
        if not 0 < n <= cap:
            raise RuntimeError(f"kernel table layout: {n} entries, expected 1..{cap}")
        lay = {names[k].decode(): values[k] for k in range(n)}
        # before the stream, the motor builds take the motor arguments (the
        # terrain + motor build also the rings' scratch), and every build its
        # launch plan (envs a block, env stride)
        own_args = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 if lay.get("LHW_MOTOR") else []
        own_args += [ctypes.c_void_p] if lay.get("LHW_MOTOR") and lay["LHW_TERRAIN"] else []
        own_args = own_args + [ctypes.c_int] * 2
        lib.lhw_control_step.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 20
            + own_args + [ctypes.c_void_p]
        )
        lib.lhw_control_step.restype = ctypes.c_int
        _LIBS[build_name] = (lib, lay)
    return _LIBS[build_name]


def build_all() -> dict:
    """Build the four libraries at once (one nvcc each, started together)
    and load them; {build name: (nvcc seconds of this call, library path,
    ptxas's registers / stack frame / spill lines)}."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {name: pool.submit(build.build_library, *args) for name, args in LIBRARIES.items()}
        built = {name: fut.result() for name, fut in futures.items()}
    for name in built:
        _library(name)
    return {name: (seconds, str(path), build.ptxas_report(path)) for name, (path, seconds) in built.items()}


def _trailing(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (rows, B) contiguous."""
    return x.reshape(x.shape[0], -1).t().contiguous()


def _check_inputs(tensors: dict, rows: dict, batch: int, device: torch.device) -> None:
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"{name}: on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if tuple(x.shape) != (rows[name], batch):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {(rows[name], batch)}")


TERRAIN_KEYS = ("terrain_pos", "terrain_size", "terrain_cos", "terrain_sin", "floor_z", "hfield", "hf_x0y0", "hf_cell")


def terrain_blocks(terrain: Terrain | None) -> dict:
    """Batch-leading Terrain -> the kernel's trailing-batch (rows, B) terrain
    inputs (None where the terrain has no such part)."""
    out = dict.fromkeys(TERRAIN_KEYS)
    if terrain is None:
        return out
    out["floor_z"] = terrain.floor_z.reshape(1, -1).contiguous()
    if terrain.pos.shape[1] > 0:
        out.update(
            terrain_pos=_trailing(terrain.pos), terrain_size=_trailing(terrain.size),
            terrain_cos=_trailing(torch.cos(terrain.yaw)), terrain_sin=_trailing(torch.sin(terrain.yaw)),
        )
    if terrain.hfield is not None:
        out.update(hfield=_trailing(terrain.hfield), hf_x0y0=_trailing(terrain.hfield_x0y0), hf_cell=_trailing(terrain.hfield_cell))
    return out


def motor_blocks(params: dict, mstate: MotorState, device: torch.device) -> dict:
    """The motor inputs of K4: the weights (motor_weights), the layer
    count and hidden widths, and the batch-leading MotorState's histories
    (B, H, nu) as joint-major trailing-batch (nu * H, B) blocks, row
    n * H + slot, oldest first; the count as int32 (1, B)."""
    dims = motor_dims(params)
    hidden = (dims[1:-1] + [0, 0])[:2]
    joint_major = lambda h: h.permute(2, 1, 0).reshape(-1, h.shape[0]).contiguous()
    return dict(
        weights=motor_weights(params, device), layers=len(dims) - 1, hid0=hidden[0], hid1=hidden[1],
        qd_hist=joint_major(mstate.qdot_hist), ct_hist=joint_major(mstate.ctau_hist),
        count=mstate.count.to(torch.int32).reshape(1, -1).contiguous(),
    )


def control_step_launch(
    model: Model, inputs: dict, frame_skip: int, sim_dt: float, settle: bool, reuse: int,
    terrain: dict | None = None, hfield_shape: tuple | None = None, motor: dict | None = None,
) -> dict:
    """Launch K1-K6 on trailing-batch (rows, B) float32 CUDA
    tensors (``terrain``: the blocks of terrain_blocks, with ``hfield_shape``
    (H, W) where there is a heightfield; ``motor``: the blocks of
    motor_blocks); returns the 12 outputs as (rows, B) tensors, with a motor
    also qd_hist, ct_hist (nu * H, B) and count (1, B) int32. K5 and K6 keep
    the histories' rings in a scratch allocated here, (B, 2 nu H) floats in
    device memory. Launches on the current stream and does not
    synchronize."""
    qpos = inputs["qpos"]
    device = qpos.device
    if device.type != "cuda":
        raise ValueError(f"control_step_launch takes CUDA tensors, got {device}")
    batch = qpos.shape[1]
    name = variant(model, hfield_shape is not None, motor is not None)
    terrain = terrain or dict.fromkeys(TERRAIN_KEYS)
    nt, hw = model.nterrain, (hfield_shape[0] * hfield_shape[1] if hfield_shape else 0)
    rows = dict(
        qpos=model.nq, qvel=model.nv, target=model.nu, kp=model.nu, kd=model.nu, bemf=model.nu,
        damping=model.nv, frictionloss=model.nv, body_mass=model.nbody, body_ipos=3 * model.nbody,
        xfrc=6 * model.nbody, terrain_pos=3 * nt, terrain_size=3 * nt, terrain_cos=nt, terrain_sin=nt,
        floor_z=1, hfield=hw, hf_x0y0=2, hf_cell=2,
    )
    boxes, hfield = TERRAIN_KEYS[:5], ("floor_z", "hfield", "hf_x0y0", "hf_cell")
    needed = {"K1": (), "K2": boxes, "K3": hfield, "K4": (), "K5": boxes, "K6": hfield}[name]
    missing = [k for k in needed if terrain.get(k) is None]
    if missing:
        raise ValueError(f"{name} needs terrain inputs {missing}")
    _check_inputs({**inputs, **terrain}, rows, batch, device)
    lib, lay = _library(LIBRARY_OF[name])
    ftab, itab = device_tables(model, device, lay, hfield_shape)
    motor_in, motor_out = [], {}
    if motor is not None:
        hrows = model.nu * lay["MAX_H"]
        _check_inputs(dict(qd_hist=motor["qd_hist"], ct_hist=motor["ct_hist"]), dict(qd_hist=hrows, ct_hist=hrows), batch, device)
        count, weights = motor["count"], motor["weights"]
        if count.device != device or count.dtype != torch.int32 or tuple(count.shape) != (1, batch) or not count.is_contiguous():
            raise ValueError(f"count: expected a contiguous int32 (1, {batch}) tensor on {device}")
        if weights.device != device or weights.dtype != torch.float32 or not weights.is_contiguous():
            raise ValueError(f"motor weights: expected a contiguous float32 tensor on {device}")
        motor_out = dict(
            qd_hist=torch.empty((hrows, batch), dtype=torch.float32, device=device),
            ct_hist=torch.empty((hrows, batch), dtype=torch.float32, device=device),
            count=torch.empty((1, batch), dtype=torch.int32, device=device),
        )
        motor_in = [weights.data_ptr(), motor["layers"], motor["hid0"], motor["hid1"],
                    motor["qd_hist"].data_ptr(), motor["ct_hist"].data_ptr(), count.data_ptr(),
                    *[x.data_ptr() for x in motor_out.values()]]
        if lay["LHW_TERRAIN"]:
            rings = torch.empty((batch, 2 * hrows), dtype=torch.float32, device=device)
            motor_in.append(rings.data_ptr())
    if (lay["LHW_TERRAIN"] or lay.get("LHW_MOTOR")) and valid_reuse(frame_skip, reuse) != 1:
        raise ValueError(f"{name} runs at R=1 (the reference pins it on terrain and with a motor), got R={reuse}")
    plan = launch_plan(model, batch, lay, hfield_shape)
    plan_args = [plan["envs_per_block"], plan["env_floats"]]
    nc = model.ncon
    out_rows = dict(
        qpos=model.nq, qvel=model.nv, qacc=model.nv, act_torque=model.nu, cforce=3 * nc, cdist=nc,
        cmask=nc, cpos=3 * nc, cnormal=3 * nc, xpos=3 * model.nbody, xquat=4 * model.nbody,
        cvel=6 * model.nbody,
    )
    outs = {k: torch.empty((r, batch), dtype=torch.float32, device=device) for k, r in out_rows.items()}
    order_in = ("qpos", "qvel", "target", "kp", "kd", "bemf", "damping", "frictionloss", "body_mass", "body_ipos", "xfrc")
    ptr = lambda x: None if x is None else x.data_ptr()
    hh, ww = hfield_shape if hfield_shape else (0, 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lhw_control_step(
            batch, int(frame_skip), int(valid_reuse(frame_skip, reuse)), int(bool(settle)), float(sim_dt),
            ftab.data_ptr(), itab.data_ptr(),
            *[inputs[k].data_ptr() for k in order_in],
            hh, ww, *[ptr(terrain[k]) for k in TERRAIN_KEYS],
            *[outs[k].data_ptr() for k in out_rows],
            *motor_in,
            *plan_args,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"control-step kernel {name} launch failed: cudaError {err}")
    counters[name].launches += 1
    return {**outs, **motor_out}


def kernel_reuse(terrain: Terrain | None, reuse_interval: int, motor: bool = False) -> int:
    """The factorization-reuse interval R a step runs at: as asked on the
    flat floor without a motor model (K1), 1 on terrain boxes or a
    heightfield (K2, K3) and with a motor model (K4), as the reference pins
    them (learninghumanoidwalking_tpu/ops/substep_kernel.py:1360-1368), and
    so on terrain with a motor model (K5, K6)."""
    return reuse_interval if terrain is None and not motor else 1


def pd_substeps_kernel(
    model: Model,
    params: DynParams,
    physics: PhysicsState,
    target: torch.Tensor,
    frame_skip: int,
    sim_dt: float,
    terrain: Terrain | None = None,
    settle: bool = False,
    reuse_interval: int = 1,
    motor=None,
):
    """Drop-in for physics/batched.py::pd_substeps_batched through K1, K2,
    K3 or (``motor``: a (motor params, MotorState) pair, returning
    (PhysicsState, MotorState)) K4, K5, K6, at the reuse interval of
    kernel_reuse on both paths.

    CPU tensors run the plain version; CUDA tensors launch the kernel; both
    in a ``physics.launch`` span (utils/trace.py)."""
    with trace.span("physics.launch"):
        device = physics.qpos.device
        hfield_shape = tuple(terrain.hfield.shape[1:]) if terrain is not None and terrain.hfield is not None else None
        name = variant(model, hfield_shape is not None, motor is not None)
        boxes = terrain is not None and terrain.pos.shape[1] > 0
        if (name in ("K2", "K5")) != boxes or (name in ("K1", "K4") and terrain is not None):
            raise ValueError(f"terrain does not fit the model ({model.nterrain} terrain boxes, heightfield {hfield_shape})")
        reuse_interval = kernel_reuse(terrain, reuse_interval, motor is not None)
        if device.type == "cpu":
            return pd_substeps_batched(
                model, params, physics, target, frame_skip, sim_dt, terrain, settle=settle, reuse_interval=reuse_interval,
                motor=motor,
            )
        if device.type != "cuda":
            raise ValueError(f"pd_substeps_kernel: unsupported device {device}")
        check_model(model, _library(LIBRARY_OF[name])[1], hfield_shape, None if motor is None else motor[0])
        batch = physics.qpos.shape[0]
        inputs = dict(
            qpos=_trailing(physics.qpos),
            qvel=_trailing(physics.qvel),
            target=_trailing(target),
            kp=_trailing(params.kp),
            kd=_trailing(params.kd),
            bemf=_trailing(params.bemf_gain),
            damping=_trailing(params.dof_damping),
            frictionloss=_trailing(params.dof_frictionloss),
            body_mass=_trailing(params.body_mass),
            body_ipos=_trailing(params.body_ipos),
            xfrc=_trailing(params.xfrc),
        )
        out = control_step_launch(
            model, inputs, frame_skip, sim_dt, settle, reuse_interval, terrain_blocks(terrain), hfield_shape,
            None if motor is None else motor_blocks(motor[0], motor[1], device),
        )
        nc, nb = model.ncon, model.nbody
        lead = lambda x, *shape: x.t().reshape(batch, *shape)
        if terrain is None:
            frame = torch.as_tensor(eng._Z_FRAME, device=device).expand(batch, nc, 3, 3)
        else:
            # the kernel returns the contact normals; the frames follow from them
            frame = eng.frame_from_normal(lead(out["cnormal"], nc, 3))
        contact = Contact(
            pos=lead(out["cpos"], nc, 3),
            frame=frame,
            dist=lead(out["cdist"], nc),
            geom=torch.as_tensor(eng.slot_geoms(model), dtype=torch.int32, device=device).expand(batch, -1),
            force=lead(out["cforce"], nc, 3),
            mask=lead(out["cmask"], nc),
        )
        state = PhysicsState(
            qpos=lead(out["qpos"], model.nq),
            qvel=lead(out["qvel"], model.nv),
            qacc=lead(out["qacc"], model.nv),
            act_torque=lead(out["act_torque"], model.nu),
            xpos=lead(out["xpos"], nb, 3),
            xquat=lead(out["xquat"], nb, 4),
            cvel=lead(out["cvel"], nb, 6),
            contact=contact,
            time=physics.time + frame_skip * sim_dt,
        )
        if motor is None:
            return state
        # joint-major (nu * H, B) -> batch-leading (B, H, nu), as views
        hist = lambda x: x.reshape(model.nu, HIST_LEN, batch).permute(2, 1, 0)
        return state, MotorState(qdot_hist=hist(out["qd_hist"]), ctau_hist=hist(out["ct_hist"]),
                                 count=out["count"].reshape(batch))


# ---------------------------------------------------------------------------
# analytic work of one launch, for the roofline bound
# ---------------------------------------------------------------------------


def motor_flops_per_net(params: dict) -> float:
    """Float operations of one env-substep's motor nets (all joints), as
    K4 runs them once the history is warm: per joint and layer d_in x d_out
    FMAs (2 each) and d_out bias adds, a tanh (8, as sin and cos) per hidden
    unit, and the skip term (a multiply and an add). The default 50 -> 32
    -> 32 -> 1 nets: 2656 FMAs, 65 bias adds, 64 tanh and 2 per joint, 70.7k
    for jvrc's 12 joints."""
    dims, nu = motor_dims(params), int(params["skip"].shape[0])
    fma = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(nu * (2 * fma + sum(dims[1:]) + 8 * sum(dims[1:-1]) + 2))


def flops_per_env_substep(model: Model, reuse: int, hfield: bool = False, motor: dict | None = None) -> float:
    """Float operations that one env-substep needs, the refresh work amortized
    over the reuse group R (an FMA counts 2; a divide or sqrt 4; sin, cos 8),
    for the flat floor, the terrain boxes, or (``hfield``) the heightfield;
    with the motor-net params ``motor``, plus motor_flops_per_net (an
    env-substep past the history's warmup: a launch's bound counts the net
    only where it runs).

    This is the least work of the step: the contact solve is counted in the
    Woodbury form of the Pallas kernel
    (learninghumanoidwalking_tpu/ops/substep_kernel.py:765-856), which
    factors the 12x12 foot-basis Gram at refresh and a 12x12 inner system per
    substep, as K1-K4 run it (K1 refreshing every R-th substep). Projected
    solves as in physics/batched.py. Terrain adds per substep: the box SDF over all boxes
    for each box slot (the normal only for the winner), 5 bilinear samples
    of 4 nodes per heightfield slot and its normal, a frame from every
    tilted normal and 6-term contact rows (slot_coeffs_frame)."""
    nb, nv, nu, nc = model.nbody, model.nv, model.nu, model.ncon
    anc = _tables(model)["anc"] > 0.5
    npairs = sum(1 for d in range(nv) for e in range(d + 1) if anc[model.dof_body[d], e])
    feet = list(dict.fromkeys(model.geom_body[g] for g in model.foot_geoms))
    nk, n3 = 6 * len(feet), 3 * nc

    def chol(n):  # Cholesky: (n^3 - n)/6 FMAs, n sqrt, n(n-1)/2 divides
        return (n**3 - n) / 3 + 4 * n + 2 * n * (n - 1)

    def fwd(n):  # one triangular solve
        return n * (n - 1) + 4 * n

    # common body: PD torque, FK, motion subspace, body velocities, world
    # inertias with mass/CoM randomization, RNE bias and applied wrenches
    per = nu * 12
    per += nb * (2 * 30 + 28 + 16 + 60 + 12 + 4 * 4 + 30) + nv * (40 + 12)
    per += nb * (54 + 54 + 18 + 27 + 8) + nb * (36 + 2 * 36 + 24 + 12) + nv * (12 + 2 + 8 + 4)
    # refresh: CRBA + armature + damping, Cholesky, Y = L^-1 B, Gram, its Cholesky
    refresh = nb * 13 + nv * 36 + npairs * 12 + 2 * nv + chol(nv)
    refresh += nk * fwd(nv) + nk * (nk + 1) / 2 * 2 * nv + chol(nk)
    per += refresh / max(reuse, 1)
    per += 2 * fwd(nv)  # smooth qacc
    # contact distances and normals per slot kind
    kinds = slot_kinds(model, hfield)
    per_box = 22  # dx dy lz, yawed lx ly, ex ey ez, inside, pen, compare to the best
    tilt = 28 + 17  # frame_from_normal; 6-term row coefficients beyond the static 3
    # one bilinear sample: 4 node weights (3 each), 2 rows and the blend;
    # u, v, their +-0.25 neighbours clipped; two slopes; the unit normal; the gap
    hf_corner = 5 * (12 + 9) + 12 + 12 + 12 + 20 + 3
    per += sum({"flat": 0, "floor": 1, "hfield": hf_corner + tilt, "box": model.nterrain * per_box + 5 + tilt}[k] for k in kinds)
    # contact rows: static frames are a 3-term expansion over the foot's 6
    # basis keys (slot_coeffs_static), tilted ones a 6-term expansion;
    # Chat = mask * C LG is lower-triangular in its key
    row_keys = []
    slot_foot = [feet.index(model.geom_body[g]) for g in eng.slot_geoms(model)]
    for c in range(nc):
        base = 6 * slot_foot[c]
        if kinds[c] in ("flat", "floor"):
            row_keys += [[base + 5, base + 1, base], [base + 3, base + 2, base + 1], [base + 4, base, base + 2]]
        else:
            row_keys += [list(range(base, base + 6))] * 3
    terms = np.array([[sum(r >= k for r in keys) for k in range(nk)] for keys in row_keys])
    nz = terms > 0
    nnz = int(nz.sum())
    per += nc * (38 + 10) + 2 * nk * (2 * nv - 1) + n3 * 47  # corners, u_vel/u_acc, aref, R, b, D
    per += int(2 * terms.sum()) + 4 * n3  # Chat, D^-1
    per += nnz + 2 * sum(int((nz[:, a] & nz[:, b]).sum()) for a in range(nk) for b in range(a, nk)) + nk
    per += chol(nk)  # K = I + Chat^T D^-1 Chat and its Cholesky
    iters = PROJ_REFINE_ITERS
    apply_ainv = 4 * nnz + 3 * n3 + 2 * fwd(nk)
    apply_a = 4 * nnz + n3
    per += iters * (apply_ainv + nc * 20) + (iters - 1) * (apply_a + 2 * n3)
    per += 6 * n3 + nk * 2 * nv + 2 * fwd(nv) + nv  # J^T f through the basis, constraint qacc
    per += nv * 4 + 60  # semi-implicit Euler, quaternion integration
    if motor is not None:
        per += motor_flops_per_net(motor)
    return float(per)


def bytes_per_launch(model: Model, batch: int, hfield_shape: tuple | None = None, motor: dict | None = None) -> int:
    """Bytes the launch must move: each input read once, each output written
    once (terrain inputs: box pos, size, cos, sin, floor_z; heightfield
    nodes, origin, spacing; with the motor-net params ``motor``, the two
    histories (nu x 25 each) and the count in and out per env, and the
    weights once)."""
    nb, nv, nq, nu, nc = model.nbody, model.nv, model.nq, model.nu, model.ncon
    rows_in = nq + nv + 4 * nu + 2 * nv + nb + 3 * nb + 6 * nb
    if model.nterrain or hfield_shape:
        rows_in += 8 * model.nterrain + 1
    if hfield_shape:
        rows_in += hfield_shape[0] * hfield_shape[1] + 4
    rows_out = nq + 2 * nv + nu + 3 * nc + 2 * nc + 6 * nc + 3 * nb + 4 * nb + 6 * nb
    motor_bytes = 0
    if motor is not None:
        weights = sum(int(motor[f"{k}{li}"].numel()) for li in range(int(motor["n_layers"])) for k in ("w", "b"))
        motor_bytes = 4 * batch * 2 * (2 * nu * HIST_LEN + 1) + 4 * (weights + nu)
    return 4 * batch * (rows_in + rows_out) + motor_bytes
