"""Drive every property module end-to-end on the GPU.

Smoke-level verification that the whole public surface (all nine
property families: atomic/molecular/intermolecular RDF+CN, number
density, hydration number, clusters, residence time, viscosity —
plus the MSD/GK paths bench.py already drives) executes on target
hardware, not just the CPU test backend. Uses the bundled
Mg(TFSI)2/DME dataset; synthetic inputs where the bundled system
lacks the physics (water for hydration, multi-replicate pressure
logs for viscosity). Run: python benchmarks/smoke_all_properties.py
(~2 min warm, longer on a cold compile cache)."""
import os, sys, time
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tests"))
import numpy as np
import jax
from mdproptools_tpu.utilities.compile_cache import use_compile_cache

use_compile_cache()

DATA = os.environ.get(
    "MDPT_DATA_DIR",
    os.path.join(os.path.dirname(HERE), "data", "mg_tfsi_dme"))
OUT = os.path.join(os.path.dirname(HERE), "bench_out", "smoke")
os.makedirs(OUT, exist_ok=True)
MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
ONE = f"{DATA}/dump.nvt.0.dump"
KW = dict(num_mols=[591, 66, 33], num_atoms_per_mol=[16, 15, 1])
t0 = time.time()
print("backend:", jax.default_backend())

from mdproptools_tpu.structural.rdf_cn import (
    calc_atomic_cn, calc_molecular_rdf, calc_molecular_cn,
    calc_intermolecular_rdf)
cn = calc_atomic_cn([3.0, 5.0], 0.05, 9, MASS, [[8, 8], [9, 1]], ONE,
                    save_mode=False, precision="fast")
assert np.isfinite(cn.to_numpy()).all()
print("atomic_cn OK", round(time.time()-t0, 1))

mr = calc_molecular_rdf(20, 0.05, 9, MASS, [[9], [1]], ONE,
                        save_mode=False, precision="fast", **KW)
assert np.isfinite(mr.to_numpy()).all()
print("molecular_rdf OK", round(time.time()-t0, 1))

mc = calc_molecular_cn([5.0], 0.05, 9, MASS, [[9], [1]], ONE,
                       save_mode=False, precision="fast", **KW)
assert np.isfinite(mc.to_numpy()).all()
print("molecular_cn OK", round(time.time()-t0, 1))

ir = calc_intermolecular_rdf(20, 0.05, 9, MASS, [[3], [1]], ONE,
                             save_mode=False, precision="fast", **KW)
assert np.isfinite(ir.to_numpy()).all()
print("intermolecular_rdf OK", round(time.time()-t0, 1))

from helpers import write_traj
from mdproptools_tpu.structural.number_density import calc_number_density
_nd = np.zeros((5, 5))
_nd[:, 0] = np.arange(1, 6)
_nd[:, 1] = [1, 2, 2, 2, 2]
_nd[:, 2] = [2.0, 2.25, 2.75, 3.25, 6.0]
_nd[:, 3] = 5.0
_nd[:, 4] = 5.0
write_traj(OUT, [0], 0.0, 30.0, ["id", "type", "x", "y", "z"], [_nd])
nd = calc_number_density("dump.test.*.dump", surface_atom=1,
                         atom_types=[2], bin_size=0.5,
                         dist_from_interface=8.0,
                         axis_norm_interface="x", working_dir=OUT,
                         results_file="nd.csv")
assert np.isfinite(nd.to_numpy()).all()
print("number_density OK", round(time.time()-t0, 1))

# hydration: synthetic cation + 2 waters (bundled system has no water)
from mdproptools_tpu.structural.hydration_number import get_hydration_number
OUT_H = os.path.join(OUT, "hyd"); os.makedirs(OUT_H, exist_ok=True)
pos = np.array([[5.0, 5, 5], [5, 5, 7], [4.4, 5, 7.8], [5.6, 5, 7.8],
                [5, 5, 3], [4.4, 5, 2.2], [5.6, 5, 2.2]])
data = np.zeros((7, 5))
data[:, 0] = np.arange(1, 8)
data[:, 1] = [1, 2, 3, 3, 2, 3, 3]
data[:, 2:5] = pos
write_traj(OUT_H, [0], 0.0, 10.0, ["id", "type", "x", "y", "z"], [data])
hn = get_hydration_number("dump.test.*.dump", cation_type=1, water_type=2,
                          r_cut=3.0, num_mols=[1, 2],
                          num_atoms_per_mol=[1, 3], working_dir=OUT_H)
assert np.isfinite(hn["hydration_factor"].iloc[0])
print("hydration_number OK", round(time.time()-t0, 1))

from mdproptools_tpu.structural.cluster_analysis import get_clusters
get_clusters(f"{DATA}/dump.nvt.2500000.dump", 9, 2.6, [591, 66, 33],
             [16, 15, 1], full_trajectory=False, frame=0,
             elements=["O", "C", "H", "N", "S", "O", "C", "F", "Mg"],
             max_force=0.75, working_dir=OUT)
n_xyz = len([f for f in os.listdir(OUT) if f.startswith("Cluster_")])
assert n_xyz > 0
print("clusters OK", n_xyz, "files", round(time.time()-t0, 1))

from mdproptools_tpu.dynamical.residence_time import ResidenceTime
rt = ResidenceTime(r_cut=[(0.0, 2.8)], partial_relations=[[9], [1]],
                   filename=f"{DATA}/dump.nvt.*.dump", dt=1,
                   working_dir=OUT, precision="fast", **KW)
corr = rt.calc_auto_correlation()
assert np.isfinite(corr.to_numpy()).all()
print("residence_time OK", round(time.time()-t0, 1))

from mdproptools_tpu.dynamical.viscosity import Viscosity
rng = np.random.default_rng(0)
T = 4000
for rep in (1, 2, 3):
    with open(f"{OUT}/log.visc_{rep}", "w") as fh:
        fh.write("Step Pxy Pxz Pyz Time\n")
        p = np.zeros((T, 3))
        for t in range(1, T):
            p[t] = 0.95 * p[t - 1] + rng.normal(size=3)
        for t in range(T):
            fh.write(f"{t} {p[t,0]:.6f} {p[t,1]:.6f} {p[t,2]:.6f} {t*1.0}\n")
visc = Viscosity(log_pattern="log.visc_*", cutoff_time=0,
                 volume=49.18 ** 3, temp=298.15, timestep=1, units="real",
                 working_dir=OUT)
va = visc.calc_avg_visc(output_all_data=False)
print("viscosity OK", round(time.time()-t0, 1))
print("ALL NINE PROPERTY MODULES OK on", jax.default_backend())
