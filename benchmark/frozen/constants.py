"""GPS / WGS-84 physical constants.

Parity: reference pygnss/pythonreceiver/libgnss/constants.py:3-15 and
cudarecv/utils/inc/consthelper.h:5-27 define the same set.

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/constants.py (host
float64 numpy, no torch): part of the yardstick, which imports nothing of
the program, so that a change to the program cannot move it.
"""

MU = 3.986005e14          # WGS-84 earth gravitational parameter [m^3/s^2]
F_REL = -4.442807633e-10  # relativistic clock correction constant [s/sqrt(m)]
OMEGA_E_DOT = 7.2921151467e-5  # earth sidereal rotation rate [rad/s]
C = 299792458.0           # speed of light [m/s]
PI = 3.1415926535898      # GPS ICD value of pi
F_L1 = 1.57542e9          # L1 carrier frequency [Hz]
F_L2 = 1.22760e9          # L2 carrier frequency [Hz]

F_CA = 1.023e6            # C/A chipping rate [chips/s]
L_CA = 1023.0             # chips per C/A code period
T_CA = 0.001              # C/A code period [s]

SEC_PER_WEEK = 604800.0
HALF_WEEK = 302400.0

# Aliases matching the reference's short names (used throughout formulas).
F = F_REL
OEDot = OMEGA_E_DOT
