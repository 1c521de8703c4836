#!/usr/bin/env python
"""
Full analysis of the bundled Mg(TFSI)2 / DME electrolyte trajectory —
the script form of the reference's example notebook
(``examples/mg_tfsi_dme_analysis.ipynb``), runnable end-to-end on one
GPU (or CPU with JAX_PLATFORMS=cpu).

System: 591 DME (16 atoms) + 66 TFSI (15 atoms) + 33 Mg; 9 atom types;
101 frames, 50k-step spacing, ~49.2 A cubic box (real units).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_REF = "/root/reference/data/mg_tfsi_dme"  # full 101-frame set if mounted
_BUNDLED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mg_tfsi_dme")
DATA = os.environ.get("MDPT_DATA",
                      _REF if os.path.isdir(_REF) else _BUNDLED)
OUT = os.environ.get("MDPT_OUT", tempfile.mkdtemp(prefix="mdpt_example_"))

MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
NUM_MOLS = [591, 66, 33]
NUM_APM = [16, 15, 1]
ELEMENTS = ["O", "C", "H", "N", "S", "O", "C", "F", "Mg"]
DUMPS = f"{DATA}/dump.nvt.*.dump"


def main():
    print(f"writing results to {OUT}")

    # ---- structural: RDF around Mg (type 9) -----------------------------
    from mdproptools_tpu.structural.rdf_cn import (
        calc_atomic_cn,
        calc_atomic_rdf,
    )

    rdf = calc_atomic_rdf(
        20, 0.05, 9, MASS, [[9, 9, 9], [1, 4, 8]], DUMPS,
        path_or_buff=f"{OUT}/rdf.csv",
    )
    print("RDF peaks: Mg-O(DME) g max =", rdf["g_9-1"].max().round(2))

    cn = calc_atomic_cn(
        [2.6, 2.6, 2.6], 0.05, 9, MASS, [[9, 9, 9], [1, 4, 8]], DUMPS,
        path_or_buff=f"{OUT}/cn.csv",
    )
    print("Mg coordination (r<2.6A):", cn.round(3).to_dict("records")[0])

    # ---- structural: solvation-shell clusters ---------------------------
    from mdproptools_tpu.structural.cluster_analysis import (
        get_clusters,
        get_unique_configurations,
    )
    from mdproptools_tpu.io.molecule import Molecule

    n = get_clusters(
        DUMPS, atom_type=9, r_cut=2.3, num_mols=NUM_MOLS,
        num_atoms_per_mol=NUM_APM, frame=50, elements=ELEMENTS,
        working_dir=OUT,
    )
    print(f"extracted {n} clusters at frame 50")
    mols = [Molecule.from_file(f"{DATA}/{m}.pdb")
            for m in ("dme", "tfsi", "mg")]
    clusters, configs = get_unique_configurations(
        "Cluster_*.xyz", 2.3, mols, mol_num=2,
        type_coord_atoms=["O", "N", "Mg"], working_dir=OUT,
        cum_perc=100, mol_names=["dme", "tfsi", "mg"], zip=False,
    )
    print("top configurations:\n", configs.head(3).to_string(index=False))

    # ---- dynamical: MSD + diffusion -------------------------------------
    from mdproptools_tpu.dynamical.diffusion import Diffusion

    d = Diffusion(timestep=1, units="real", outputs_dir=DATA, diff_dir=OUT)
    msd, _ = d.get_msd_from_dump(
        "dump.nvt.*.dump", msd_type="com", num_mols=NUM_MOLS,
        num_atoms_per_mol=NUM_APM, mass=MASS, com_drift=True,
        precision="fast",
    )
    diff = d.calc_diff(msd, diff_names=["dme", "tfsi", "mg"], save=True)
    print("diffusion coefficients (m^2/s):")
    print(diff.to_string())

    # ---- dynamical: GK conductivity -------------------------------------
    from mdproptools_tpu.dynamical.conductivity import Conductivity

    cond = Conductivity(
        "dump.nvt.*.dump", NUM_MOLS, NUM_APM, volume=49.18**3, mass=MASS,
        temp=298.15, working_dir=DATA, precision="fast",
    )
    j = cond.get_charge_flux()
    tot = cond.correlate_charge_flux(j)
    integ = cond.integrate_charge_flux_correlation(tot)
    ave, _ = cond.fit_curve(tot, integ, tol=0.5)
    sigma = cond.green_kubo(ave)
    print("GK conductivity per mol type + total (S/m):", sigma.round(2))
    print("(101 frames at 50k-step spacing is far too sparse for converged")
    print(" GK integrals - this demonstrates the pipeline, not physics)")

    # ---- dynamical: residence time ---------------------------------------
    from mdproptools_tpu.dynamical.residence_time import ResidenceTime

    rt = ResidenceTime(
        r_cut=[(0.0, 2.6)], partial_relations=[[9], [1]], filename=DUMPS,
        working_dir=OUT, precision="fast",
    )
    corr = rt.calc_auto_correlation()
    print("Mg-O(DME) shell survival C(t) head:",
          corr["9-1"].to_numpy()[:4].round(4))

    # ---- composite: one parse, all three properties ----------------------
    # the shared-parse pipeline folds each parsed frame block into the
    # RDF + MSD + GK streams at once (identical results, one file pass)
    from mdproptools_tpu import analyze

    composite = analyze(
        "dump.nvt.*.dump", 9, MASS, num_mols=NUM_MOLS,
        num_atoms_per_mol=NUM_APM,
        rdf=dict(r_cut=20.0, bin_size=0.05,
                 partial_relations=[[9], [1]], save_mode=False),
        msd=dict(msd_type="com", calc_diff=False),
        conductivity=dict(volume=49.18**3, fit=False),
        precision="fast", working_dir=DATA,
    )
    print("composite keys:", sorted(composite))
    print(f"done; artifacts in {OUT}")


if __name__ == "__main__":
    main()
