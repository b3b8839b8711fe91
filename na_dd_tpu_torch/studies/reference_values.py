"""The reference notebooks' saved outputs and the JAX package's CPU-x64
values of the reproduction (counterpart of ``studies/reference_values.py``,
copied so that the port depends on nothing of it).

* ``REFERENCE_ERRORS``, ``REFERENCE_FINEST_WALLCLOCK`` and
  ``REFERENCE_FINAL_RATE`` are copied from ``studies/reference_values.py``,
  which extracted them from the ``Overall error:`` stream outputs, the
  finest levels' ``Completed in`` lines and the final rates of the six
  ``*_reghcstriple_convergence_study.ipynb`` notebooks (cells 9/10/11 and
  12/13).  The pol notebook prints 6 significant digits; the others print 13.
* ``CPU_X64_ERRORS[(study, kind)] = {level: error}`` is copied from
  ``studies/results/reproduction_cpu_x64.json``, made by
  ``JAX_PLATFORMS=cpu python studies/reproduction_cpu_x64.py``: the JAX
  harness function that ``studies/run_all_tpu.py`` calls for the run
  (``run_spatial_study``, ``run_temporal_study`` or
  ``run_eta_study_batched``), on the CPU in float64, at every level whose
  cost is within ``CPU_X64_BUDGET`` node-steps (the JAX script's
  adjudication budget, ``studies/adjudicate_level.py`` ``level_cost``).
  The N=256 level of the four Tf = 1 spatial ladders is over it and has no
  value.

Protocols (from the notebook cell sources): spatial N = 2·2^k, k = 0..7,
dt = h^1.5, Tf = 0.01 for pol/expsin and 1.0 for nfsp*/peaks, eta = 50;
temporal dt = base_dt/2^k on a fixed grid (the peaks study recomputes
N = ceil(1/(2·dt)) per level, hence its two exact 0.0 levels); eta: N = 32,
dt = 5e-4, Tf = 0.01, eta in {10, 50, 100, 200, 300, 500, 1000}.
"""

#: The repo's reference-parity gate (relative).
PARITY_GATE = 1e-8
#: The node-step budget of the CPU-x64 record (``run_all_tpu._adjudicate``).
CPU_X64_BUDGET = 5e7
#: Where ``CPU_X64_ERRORS`` was copied from.
CPU_X64_RECORD = "studies/results/reproduction_cpu_x64.json"

REFERENCE_ERRORS = {
    ("pol", "spatial"): [
        4.93452e-05, 1.59616e-05, 4.28269e-06, 1.08800e-06,
        2.75006e-07, 6.96085e-08, 1.74802e-08, 4.38284e-09,
    ],
    ("expsin", "spatial"): [
        1.942652829989e-05, 5.197056624911e-06, 1.322695968641e-06,
        3.372248813359e-07, 8.344194130557e-08, 2.052209700229e-08,
        5.119616858484e-09, 1.278782670173e-09,
    ],
    ("nfsp_cpcsH1_TclcdH2", "spatial"): [
        1.387299517318e-05, 8.822763874973e-05, 3.383480896506e-05,
        1.517524996184e-05, 3.747930839694e-06, 6.816794044645e-07,
        2.799670822833e-07, 8.645407062247e-08,
    ],
    ("nfsp_cpcsH2_TclcdH2", "spatial"): [
        1.877869516145e-05, 2.037364736137e-05, 8.851905299491e-06,
        3.085671522449e-06, 8.603180933041e-07, 2.660430202155e-07,
        8.453466133015e-08, 7.641023132398e-08,
    ],
    ("nfsp_cpcsH2_TclcdH3", "spatial"): [
        1.706334182719e-05, 1.734312300666e-05, 8.519357549781e-06,
        2.640813480048e-06, 7.168895437498e-07, 1.844956739082e-07,
        4.710500390333e-08, 1.180466192215e-08,
    ],
    ("peaks_fast1e1", "spatial"): [
        3.410697138975e-01, 2.998593199634e-01, 4.558178972447e-02,
        6.673442252443e-03, 1.083722320571e-03, 2.251962441053e-04,
        5.355729294822e-05, 1.329324479086e-05,
    ],
    ("pol", "temporal"): [3.60101e-08, 8.49854e-09, 4.01980e-09, 4.18199e-09],
    ("expsin", "temporal"): [
        1.036215100290e-07, 8.344194130557e-08, 8.193792525959e-08,
        8.181573405295e-08, 8.180115032463e-08, 8.179850160373e-08,
    ],
    ("nfsp_cpcsH2_TclcdH3", "temporal"): [
        2.293853773997e-10, 1.984988392477e-10,
        2.134913177290e-10, 2.184209586590e-10,
    ],
    ("nfsp_cpcsH2_TclcdH2", "temporal"): [
        1.336453753218e-09, 1.169004286281e-09,
        1.132086126593e-09, 1.123260655389e-09,
    ],
    ("nfsp_cpcsH1_TclcdH2", "temporal"): [
        1.713006210334e-09, 1.353723332525e-09,
        1.365070781516e-09, 1.374905111409e-09,
    ],
    ("peaks_fast1e1", "temporal"): [
        0.0, 0.0, 7.108884464820e-01, 9.864776561636e-01,
        3.221709152999e-01, 8.453668420359e-02, 2.135342688180e-02,
        5.351596147453e-03, 1.338721547608e-03,
    ],
    ("pol", "eta"): [2.78759e-07] * 7,
    ("expsin", "eta"): [
        8.179982876369e-08, 8.179982920798e-08, 8.179982937825e-08,
        8.179982942569e-08, 8.179982943273e-08, 8.179982943698e-08,
        8.179982943940e-08,
    ],
    ("nfsp_cpcsH1_TclcdH2", "eta"): [
        7.360771456680e-08, 7.360771456678e-08, 7.360771456676e-08,
        7.360771456673e-08, 7.360771456671e-08, 7.360771456671e-08,
        7.360771456676e-08,
    ],
    ("nfsp_cpcsH2_TclcdH2", "eta"): [
        1.335768487783e-08, 1.335768487784e-08, 1.335768487785e-08,
        1.335768487788e-08, 1.335768487790e-08, 1.335768487794e-08,
        1.335768487802e-08,
    ],
    ("nfsp_cpcsH2_TclcdH3", "eta"): [
        1.324294360382e-08, 1.324294360382e-08, 1.324294360383e-08,
        1.324294360383e-08, 1.324294360384e-08, 1.324294360385e-08,
        1.324294360388e-08,
    ],
    ("peaks_fast1e1", "eta"): [
        7.498440503481e-05, 7.498440503313e-05, 7.498440503312e-05,
        7.498440503312e-05, 7.498440503312e-05, 7.498440503312e-05,
        7.498440503312e-05,
    ],
}

# Finest-level wall-clock (seconds) from the notebooks' saved outputs
# (author CPU; BASELINE.md).
REFERENCE_FINEST_WALLCLOCK = {
    ("pol", "spatial"): 280.4,
    ("expsin", "spatial"): 247.1,
    ("nfsp_cpcsH2_TclcdH3", "spatial"): 24204.0,
    ("nfsp_cpcsH2_TclcdH2", "spatial"): 23092.0,
    ("nfsp_cpcsH1_TclcdH2", "spatial"): 24416.0,
    ("peaks_fast1e1", "spatial"): 25145.0,
    ("pol", "temporal"): 24.5,
    ("expsin", "temporal"): 2.11,
    ("nfsp_cpcsH2_TclcdH2", "temporal"): 32.6,
    ("nfsp_cpcsH2_TclcdH3", "temporal"): 25.3,
    ("nfsp_cpcsH1_TclcdH2", "temporal"): 58.96,
    ("peaks_fast1e1", "temporal"): 2108.5,
    # eta sweeps: the reference runs the 7 factors serially; the comparable
    # number is the SUM of its per-factor "Completed in ... seconds" lines
    # (each notebook's eta cell; cell 12 in nfsp_H2H2, cell 13 elsewhere)
    # since the sweep runs all 7 as one batch.
    ("pol", "eta"): 4.64,
    ("expsin", "eta"): 10.60,
    ("nfsp_cpcsH2_TclcdH3", "eta"): 4.98,
    ("nfsp_cpcsH2_TclcdH2", "eta"): 6.96,
    ("nfsp_cpcsH1_TclcdH2", "eta"): 8.92,
    ("peaks_fast1e1", "eta"): 7.75,
}

# Final observed 3-point rates as reported by the notebooks.
REFERENCE_FINAL_RATE = {
    ("pol", "spatial"): 1.993,
    ("expsin", "spatial"): 2.004,
    ("nfsp_cpcsH2_TclcdH3", "spatial"): 1.961,
    ("nfsp_cpcsH2_TclcdH2", "spatial"): 4.482,
    ("nfsp_cpcsH1_TclcdH2", "spatial"): 1.054,
    ("peaks_fast1e1", "spatial"): 2.092,
    ("expsin", "temporal"): 2.461,
    ("nfsp_cpcsH2_TclcdH2", "temporal"): 2.065,
    ("peaks_fast1e1", "temporal"): 1.996,
}

# The JAX package's CPU-x64 errors of each run, level by level (see above).
CPU_X64_ERRORS = {
    ("pol", "spatial"): {
        0: 4.934519423367602e-05,
        1: 1.596157861382319e-05,
        2: 4.282692732192525e-06,
        3: 1.087998167311069e-06,
        4: 2.750060013224652e-07,
        5: 6.960848974797674e-08,
        6: 1.7480232865543962e-08,
        7: 4.382843202899936e-09,
    },
    ("pol", "temporal"): {
        0: 3.601005705979531e-08,
        1: 8.498535472736817e-09,
        2: 4.019800984460384e-09,
        3: 4.181994727996142e-09,
    },
    ("pol", "eta"): {
        0: 2.787588142094822e-07,
        1: 2.787588142086098e-07,
        2: 2.7875881420842784e-07,
        3: 2.7875881420839597e-07,
        4: 2.7875881420838924e-07,
        5: 2.787588142083843e-07,
        6: 2.787588142083802e-07,
    },
    ("expsin", "spatial"): {
        0: 1.942652829988534e-05,
        1: 5.197056624895749e-06,
        2: 1.3226959686232761e-06,
        3: 3.3722488122410403e-07,
        4: 8.344194124202252e-08,
        5: 2.0522096998506543e-08,
        6: 5.1196168596202826e-09,
        7: 1.27878267573471e-09,
    },
    ("expsin", "temporal"): {
        0: 1.0362150962760178e-07,
        1: 8.344194124202252e-08,
        2: 8.193792524793204e-08,
        3: 8.181573405090872e-08,
        4: 8.180115032173524e-08,
        5: 8.179850160032263e-08,
    },
    ("expsin", "eta"): {
        0: 8.17998287601488e-08,
        1: 8.179982920444358e-08,
        2: 8.179982937471591e-08,
        3: 8.179982942214605e-08,
        4: 8.179982942918762e-08,
        5: 8.179982943344475e-08,
        6: 8.179982943586046e-08,
    },
    ("nfsp_cpcsH2_TclcdH3", "spatial"): {
        0: 1.7063341827192846e-05,
        1: 1.7343123006659925e-05,
        2: 8.519357549782024e-06,
        3: 2.6408134800482076e-06,
        4: 7.168895437507961e-07,
        5: 1.844956739088572e-07,
        6: 4.710500390196441e-08,
    },
    ("nfsp_cpcsH2_TclcdH3", "temporal"): {
        0: 2.2938537739744163e-10,
        1: 1.9849883924238333e-10,
        2: 2.134913177297374e-10,
        3: 2.1842095865914647e-10,
    },
    ("nfsp_cpcsH2_TclcdH3", "eta"): {
        0: 1.3242943603826662e-08,
        1: 1.3242943603830263e-08,
        2: 1.324294360383462e-08,
        3: 1.3242943603842836e-08,
        4: 1.3242943603850352e-08,
        5: 1.3242943603863258e-08,
        6: 1.3242943603884452e-08,
    },
    ("nfsp_cpcsH2_TclcdH2", "spatial"): {
        0: 1.8778695161450277e-05,
        1: 2.0373647361373918e-05,
        2: 8.851905299491398e-06,
        3: 3.0856715224486392e-06,
        4: 8.603180933053157e-07,
        5: 2.6604302021650614e-07,
        6: 8.453466133046201e-08,
    },
    ("nfsp_cpcsH2_TclcdH2", "temporal"): {
        0: 1.3364537532347e-09,
        1: 1.1690042862696056e-09,
        2: 1.1320861265277995e-09,
        3: 1.1232606553575292e-09,
    },
    ("nfsp_cpcsH2_TclcdH2", "eta"): {
        0: 1.335768487783912e-08,
        1: 1.3357684877849718e-08,
        2: 1.3357684877862696e-08,
        3: 1.335768487788765e-08,
        4: 1.3357684877911126e-08,
        5: 1.3357684877953206e-08,
        6: 1.3357684878029095e-08,
    },
    ("nfsp_cpcsH1_TclcdH2", "spatial"): {
        0: 1.3872995173177303e-05,
        1: 8.822763874973063e-05,
        2: 3.383480896506483e-05,
        3: 1.5175249961835975e-05,
        4: 3.747930839695529e-06,
        5: 6.816794044647461e-07,
        6: 2.799670822749003e-07,
    },
    ("nfsp_cpcsH1_TclcdH2", "temporal"): {
        0: 1.7130062103452477e-09,
        1: 1.3537233325147365e-09,
        2: 1.3650707814601498e-09,
        3: 1.3749051113838462e-09,
    },
    ("nfsp_cpcsH1_TclcdH2", "eta"): {
        0: 7.360771456680565e-08,
        1: 7.360771456678744e-08,
        2: 7.360771456676592e-08,
        3: 7.360771456673156e-08,
        4: 7.360771456671233e-08,
        5: 7.360771456671125e-08,
        6: 7.360771456676399e-08,
    },
    ("peaks_fast1e1", "spatial"): {
        0: 0.3410697138974629,
        1: 0.29985931996337006,
        2: 0.04558178972429455,
        3: 0.006673442251964519,
        4: 0.00108372232027919,
        5: 0.00022519624401421567,
        6: 5.355729292636085e-05,
    },
    ("peaks_fast1e1", "eta"): {
        0: 7.498440503480677e-05,
        1: 7.49844050331258e-05,
        2: 7.498440503311753e-05,
        3: 7.498440503311737e-05,
        4: 7.498440503311776e-05,
        5: 7.498440503311828e-05,
        6: 7.498440503311882e-05,
    },
    ("peaks_fast1e1", "temporal"): {
        0: 0.0,
        1: 0.0,
        2: 0.71088844648202,
        3: 0.986477656163644,
        4: 0.32217091529904657,
        5: 0.084536684199576,
        6: 0.021353426877117797,
        7: 0.005351596144069814,
        8: 0.001338721545617879,
    },
}
