"""Physical constants and BAHAMAS gas fractions.

A copy of ``baryon_painter_tpu/utils/constants.py``.

Native equivalent of the reference's Fortran constants module
(code/make_grid/constants.f90): the subset used by the pipeline (pressure
conversion, y-map assembly) plus SI conversions.
"""
import math

PI = math.pi

# SI / astro units
K_B = 1.38065e-23            # Boltzmann [J/K]
M_P = 1.6726e-27             # proton mass [kg]
EV = 1.60218e-19             # electronvolt [J]
EV_ERG = EV * 1e7            # electronvolt [erg]
MSUN = 1.989e30              # solar mass [kg]
MPC = 3.086e22               # megaparsec [m]
CM = 0.01                    # centimetre [m]

# critical density [(Msun/h) / (Mpc/h)^3]
CRITICAL_DENSITY = 2.775e11

# sigma_T / (m_e c^2) [SI: m^2/J]; process_SLICS.py:41 & constants.f90
Y_FAC_SI = 8.125561e-16

# BAHAMAS gas composition (constants.f90; BAHAMAS_sheets.f90:329-339)
FH = 0.752       # hydrogen mass fraction Y_H
MU = 0.61        # mean molecular weight mu_H
XE = 1.17        # n_e / n_H for primordial ionized gas
XI = 1.08        # n_i / n_H

# mass unit of McCarthy particle files [Msun per file unit]
MCCARTHY_MASS_FAC = 1e10
