"""Observability: verbose console log, per-iteration CSV, problem snapshot.

Counterparts of the reference's src/util.c (verbose header/iteration table)
and src/rw.c (write_data_filename), with the CSV column schema matching the
reference's log_csv_filename output exactly (36 columns; schema recovered
from notebooks/analyze_csv_logs.ipynb cell 3).
"""

from __future__ import annotations

import numpy as np

CSV_COLUMNS = [
    "iter",
    "res_pri",
    "res_dual",
    "gap",
    "ax_s_btau_nrm_inf",
    "px_aty_ctau_nrm_inf",
    "ax_s_btau_nrm_2",
    "px_aty_ctau_nrm_2",
    "res_infeas",
    "res_unbdd_a",
    "res_unbdd_p",
    "pobj",
    "dobj",
    "tau",
    "kap",
    "res_pri_normalized",
    "res_dual_normalized",
    "gap_normalized",
    "ax_s_btau_nrm_inf_normalized",
    "px_aty_ctau_nrm_inf_normalized",
    "ax_s_btau_nrm_2_normalized",
    "px_aty_ctau_nrm_2_normalized",
    "res_infeas_normalized",
    "res_unbdd_a_normalized",
    "res_unbdd_p_normalized",
    "pobj_normalized",
    "dobj_normalized",
    "tau_normalized",
    "kap_normalized",
    "scale",
    "diff_u_ut_nrm_2",
    "diff_v_v_prev_nrm_2",
    "diff_u_ut_nrm_inf",
    "diff_v_v_prev_nrm_inf",
    "aa_norm",
    "time",
]


class CsvLogger:
    def __init__(self, filename):
        self.f = open(filename, "w")
        # trailing comma matches the reference writer (pandas reads an
        # 'Unnamed: 36' column from its logs)
        self.f.write(",".join(CSV_COLUMNS) + ",\n")

    def write_row(self, values: dict):
        def fmt(c):
            v = values.get(c, 0.0)
            # integer columns (iter) stay integers, like the reference's
            # %i writer
            return repr(v) if isinstance(v, int) else repr(float(v))

        self.f.write(",".join(fmt(c) for c in CSV_COLUMNS) + ",\n")

    def close(self):
        self.f.flush()
        self.f.close()


HEADER = r"""------------------------------------------------------------------
             scs_tpu v{version} - JAX conic solver
         (c) re-designed from SCS, Brendan O'Donoghue, 2012
------------------------------------------------------------------
problem:  variables n: {n}, constraints m: {m}
cones: {cones}
settings: eps_abs: {eps_abs:.1e}, eps_rel: {eps_rel:.1e}, eps_infeas: {eps_infeas:.1e}
          alpha: {alpha:.2f}, scale: {scale:.2e}, adaptive_scale: {adaptive_scale}
          max_iters: {max_iters}, normalize: {normalize}
          acceleration_lookback: {lookback}, acceleration_interval: {interval}
lin-sys:  {linsys}
------------------------------------------------------------------
 iter | pri res | dua res |   gap   |   obj   |  scale  | time (s)
------------------------------------------------------------------"""


def print_header(settings, m, n, spec, linsys, version):
    cone_desc = []
    if spec.z:
        cone_desc.append(f"z: primal zero / dual free vars: {spec.z}")
    if spec.l:
        cone_desc.append(f"l: linear vars: {spec.l}")
    if spec.bsize:
        cone_desc.append(f"b: box cone vars: {spec.bsize}")
    if spec.q:
        cone_desc.append(f"q: soc vars: {sum(spec.q)}, qsize: {len(spec.q)}")
    if spec.s:
        cone_desc.append(f"s: psd vars: {sum(n_*(n_+1)//2 for n_ in spec.s)}, ssize: {len(spec.s)}")
    if spec.cs:
        cone_desc.append(f"cs: complex psd vars: {sum(n_*n_ for n_ in spec.cs)}")
    if spec.ep:
        cone_desc.append(f"e: exp vars: {3*spec.ep}")
    if spec.ed:
        cone_desc.append(f"ed: dual exp vars: {3*spec.ed}")
    if spec.p:
        cone_desc.append(f"p: power vars: {3*len(spec.p)}")
    print(
        HEADER.format(
            version=version,
            n=n,
            m=m,
            cones="; ".join(cone_desc) or "(none)",
            eps_abs=settings.eps_abs,
            eps_rel=settings.eps_rel,
            eps_infeas=settings.eps_infeas,
            alpha=settings.alpha,
            scale=settings.scale,
            adaptive_scale=int(settings.adaptive_scale),
            max_iters=settings.max_iters,
            normalize=int(settings.normalize),
            lookback=settings.acceleration_lookback,
            interval=settings.acceleration_interval,
            linsys=linsys,
        ),
        flush=True,
    )


def print_iter_line(it, res_pri, res_dual, gap, pobj, scale, elapsed):
    print(
        f"{it:6d}| {res_pri:8.2e} {res_dual:8.2e} {gap:8.2e} "
        f"{pobj:9.2e} {scale:8.2e} {elapsed:9.2e}",
        flush=True,
    )


def print_footer(info):
    print("------------------------------------------------------------------")
    print(f"status:  {info['status']}")
    print(
        f"timings: total: {info['setup_time'] + info['solve_time']:.2e}s "
        f"= setup: {info['setup_time']:.2e}s + solve: {info['solve_time']:.2e}s"
    )
    print(
        f"         lin-sys: {info['lin_sys_time']:.2e}s, cones: "
        f"{info['cone_time']:.2e}s, accel: {info['accel_time']:.2e}s"
    )
    print(f"objective = {info['pobj']:.6f}")
    print("------------------------------------------------------------------", flush=True)


def write_problem(filename, data, cone, settings_dict):
    """Problem snapshot for offline repro (reference: src/rw.c via
    write_data_filename, scsobject.h:493). A ".bin" suffix selects the
    native C++ binary format (csc_ops.cpp, rw.c analogue); anything else
    writes the npz container."""
    if str(filename).endswith(".bin"):
        from . import native

        native.write_problem_bin(filename, data, cone, settings_dict)
        return
    from scipy import sparse

    arrays = {
        "b": np.asarray(data["b"]),
        "c": np.asarray(data["c"]),
    }
    A = data["A"]
    if sparse.issparse(A):
        A = A.tocsc()
        arrays.update(A_data=A.data, A_indices=A.indices, A_indptr=A.indptr,
                      A_shape=np.array(A.shape))
    else:
        arrays["A_dense"] = np.asarray(A)
    P = data.get("P")
    if P is not None:
        if sparse.issparse(P):
            P = P.tocsc()
            arrays.update(P_data=P.data, P_indices=P.indices, P_indptr=P.indptr,
                          P_shape=np.array(P.shape))
        else:
            arrays["P_dense"] = np.asarray(P)
    cone_arrays = {f"cone_{k}": np.asarray(v) for k, v in cone.items()}
    stg_arrays = {
        f"stg_{k}": np.asarray(v)
        for k, v in settings_dict.items()
        if isinstance(v, (int, float, bool))
    }
    np.savez(filename, **arrays, **cone_arrays, **stg_arrays)


def read_problem(filename):
    """Load a problem snapshot written by `write_problem`."""
    if str(filename).endswith(".bin"):
        from . import native

        return native.read_problem_bin(filename)
    from scipy import sparse

    with np.load(filename, allow_pickle=False) as z:
        data = {"b": z["b"], "c": z["c"]}
        if "A_dense" in z:
            data["A"] = z["A_dense"]
        else:
            data["A"] = sparse.csc_matrix(
                (z["A_data"], z["A_indices"], z["A_indptr"]),
                shape=tuple(z["A_shape"]),
            )
        if "P_dense" in z:
            data["P"] = z["P_dense"]
        elif "P_data" in z:
            data["P"] = sparse.csc_matrix(
                (z["P_data"], z["P_indices"], z["P_indptr"]),
                shape=tuple(z["P_shape"]),
            )
        cone = {}
        settings = {}
        for k in z.files:
            if k.startswith("cone_"):
                v = z[k]
                cone[k[5:]] = v.tolist() if v.ndim else v[()]
            elif k.startswith("stg_"):
                settings[k[4:]] = z[k][()]
    return data, cone, settings
