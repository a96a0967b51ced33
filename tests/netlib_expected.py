"""Expected netlib objectives.

Values and tolerances exactly as the reference's tests/netlib/test.rs, which
sources them from Gurobi, Coin CLP 1.17.6, GLPK 4.65, and Koch's "The final
Netlib-LP results".  ``ignored`` mirrors the reference's #[ignore] markers —
the de-facto performance frontier of exact single-core RELP that the device
build aims to clear.
"""

# name -> (expected objective, abs tolerance, ignored-in-reference?)
NETLIB_EXPECTED = {
    # The reference's (never-run, ignored) test uses Gurobi's rounded
    # 5.5018459e3; Koch's exact value is 0.55018458882867417e4 and our
    # certified exact answer matches it.
    "25FV47": (5501.8458882867417, 1e-5, True),
    "80BAU3B": (9.872241924e05, 1e-5, True),
    "ADLITTLE": (2.254949632e05, 1e-3, False),
    "AFIRO": (-464.75314, 1e-4, False),
    "AGG": (-0.35991767286576506712640824319636e8, 1e-3, False),
    "AGG2": (-0.20239252355977109024317661926133e8, 1e-3, False),
    "AGG3": (0.10312115935089225579061058796215e8, 1e-3, False),
    "BANDM": (-0.15862801845012064052174123768736e3, 1e-6, True),
    "BEACONFD": (0.335924858072e5, 1e-4, False),
    "BLEND": (-30.81215, 1e-6, False),
    "BNL1": (0.19776295615228892439564398331821e4, 1e-4, True),
    "BNL2": (0.1811236540358545170448413697691e4, 1e-4, True),
    "BOEING1": (-0.3352135675071266218429697314682e3, 1e-7, False),
    "BOEING2": (-0.31501872801520287870462195913263e3, 1e-7, False),
    "BORE3D": (0.13730803942084927215581987251301e4, 1e-6, False),
    "BRANDY": (0.15185098964881283835426751550618e4, 1e-5, False),
    "CAPRI": (0.26900129137681610087717280693754e4, 1e-5, False),
    "CYCLE": (-0.52263930248941017172447233836217e1, 1e-7, True),
    "CZPROB": (0.21851966988565774858951155947191e7, 1e-2, False),
    "E226": (-0.18751929066370549102605687681285e2, 1e-6, False),
    "ETAMACRO": (-0.7557152333749133350792583667773e3, 1e-4, False),
    "FINNIS": (0.17279106559561159432297900375543e6, 1e-3, False),
    "GREENBEA": (-0.72555248129845987457557870574845e8, 1e-2, True),
    "GREENBEB": (-0.43022602612065867539213672544432e7, 1e-3, True),
    "GFRD-PNC": (0.69022359995488088295415596232193e7, 1e-3, False),
    # The reference's (ignored) test records Koch's magnitude with a flipped
    # sign; canonical netlib GROW7 minimizes to the negative value.
    "GROW7": (-0.47787811814711502616766956242865e8, 1e-1, True),
    "ISRAEL": (-0.89664482186304572966200464196045e6, 1e-3, False),
    "KB2": (-1.749900130e03, 1e-7, False),
    "LOTFI": (-0.2526470606188e2, 1e-8, False),
    "MODSZK1": (0.32061972906431580494333823530763e3, 1e-6, True),
    "SC50A": (-6.457507706e01, 1e-5, False),
    "SC50B": (-70.0, 1e-8, False),
    "SC105": (-5.220206121e01, 1e-8, False),
    "SC205": (-5.220206121e01, 1e-8, False),
    "SCAGR7": (-2.331389824e06, 1e-3, False),
    "SCRS8": (0.90429695380079143579923107948844e3, 1e-7, False),
    "SCSD1": (0.86666666743333647292533502995263e1, 1e-7, False),
    "SCFXM1": (0.18416759028348943683579089143655e5, 1e-3, True),
    "SCORPION": (0.18781248227381066296479411763586e4, 1e-6, False),
    "SCTAP1": (0.141225e4, 1e-4, False),
    "STAIR": (-0.25126695119296330352803637106304e3, 1e-4, True),
    "STANDATA": (0.12576995e4, 1e-4, False),
    "STANDMPS": (0.14060175e4, 1e-4, False),
    "STOCFOR1": (-4.113197622e04, 1e-6, False),
    "SHARE1B": (-0.7658931857918568112797274346007e5, 1e-5, False),
    "SHARE2B": (-4.157322407e02, 1e-7, False),
    "RECIPELP": (-0.266616e3, 1e-7, False),
    "VTP-BASE": (0.1298314624613613657395984384889e6, 1e-4, False),
}

# --- Extended coverage beyond the reference's 48 test functions ---------
#
# The reference ships 104 netlib SIF files (tests/netlib/problem_files/) but
# writes tests for only 48 of them; the other 54 are never solved by RELP at
# all.  We sweep them too.  External objectives below are Koch, "The final
# Netlib-LP results" (Oper. Res. Letters 32, 2004) / the canonical netlib
# README values, recalled to the precision given; entries marked None have no
# trusted external value on hand.  Either way the HARD gate for these
# problems is our own exact rational certification (optimal basis proved by
# Dixon solves + reduced-cost sign check), not the float comparison: a
# certified objective is correct by construction.  Tolerances are therefore
# looser than the reference table's (external values serve as a sanity
# cross-check, catching e.g. parse or sign errors).
#
# name -> (approx expected objective or None, abs tolerance or None)
NETLIB_EXTRA = {
    "CRE-A": (2.3595407e7, 3e2),
    "CRE-C": (2.5275116e7, 3e2),
    "D2Q06C": (122784.21, 1e0),
    "D6CUBE": (315.4917, 1e-2),
    "DEGEN2": (-1435.178, 1e-2),
    "DEGEN3": (-987.294, 1e-2),
    "DFL001": (1.12664e7, 2e3),
    "FFFFF800": (555679.61, 1e0),
    "FIT1D": (-9146.378, 1e-1),
    "FIT1P": (9146.378, 1e-1),
    "FIT2P": (68464.293, 1e0),
    "FORPLAN": (-664.2190, 1e-2),
    "GANGES": (-109585.736, 1e-1),
    "GROW15": (-1.0687094e8, 1e3),
    "GROW22": (-1.6083434e8, 1e3),
    "KEN-07": (-6.7952044e8, 1e4),
    "KEN-11": (-6.9723823e9, 1e5),
    "MAROS": (-58063.744, 1e0),
    "NESM": (1.40760365e7, 1e3),
    "PDS-02": (2.8857862e10, 1e6),
    "PDS-06": (2.7761038e10, 1e6),
    "PEROLD": (-9380.7553, 1e-1),
    "PILOT": (-557.48973, 1e-2),
    "PILOT-JA": (-6113.1365, 1e-1),
    "PILOT-WE": (-2720107.5, 1e1),
    "PILOT4": (-2581.1393, 1e-1),
    "PILOT87": (301.71035, 1e-2),
    "PILOTNOV": (-4497.2762, 1e-1),
    "QAP8": (203.5, 1e-2),
    "QAP12": (522.894, 1e0),
    "QAP15": (1040.994, 1e1),
    "SCAGR25": (-1.4753433e7, 1e2),
    "SCFXM2": (36660.2616, 1e-1),
    "SCFXM3": (54901.2545, 1e-1),
    "SCSD6": (50.5, 1e-4),
    "SCSD8": (905.0, 1e-3),
    "SCTAP2": (1724.8071, 1e-2),
    "SCTAP3": (1424.0, 1e-2),
    "SEBA": (15711.6, 1e-1),
    "SHELL": (1.208825346e9, 1e3),
    "SHIP04L": (1793324.538, 1e0),
    "SHIP04S": (1798714.700, 1e0),
    "SHIP08L": (1909055.211, 1e0),
    "SHIP08S": (1920098.211, 1e0),
    "SHIP12L": (1470187.919, 1e0),
    "SHIP12S": (1489236.134, 1e0),
    "SIERRA": (1.5394362e7, 1e3),
    "STANDGUB": (1257.6995, 1e-2),
    "STOCFOR2": (-39024.4085, 1e-1),
    # The recalled value (-39976.6616) disagrees with our exactly-certified
    # optimum by 0.12; HiGHS independently reproduces our value on both the
    # raw and the presolved standardization of the shipped SIF (canonical
    # 16675x16695 dimensions), so the recalled digits were wrong (r4).
    "STOCFOR3": (-39976.783943649585, 1e-1),
    "TRUSS": (458815.847, 1e0),
    "TUFF": (0.29214776, 1e-4),
    "WOOD1P": (1.44290241, 1e-4),
    "WOODW": (1.30447633, 1e-4),
}
