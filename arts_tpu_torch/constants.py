"""Physical constants (SI, CODATA-2018); the same values as
arts_tpu/constants.py, kept here so the port imports nothing of arts_tpu."""

import math

c = 299_792_458.0  # speed of light [m/s]
h = 6.626_070_15e-34  # Planck constant [J s]
k = 1.380_649e-23  # Boltzmann constant [J/K]
NA = 6.022_140_76e23  # Avogadro constant [1/mol]
R = NA * k  # molar gas constant [J/(mol K)]
e = 1.602_176_634e-19  # elementary charge [C]
bohr_magneton = 9.274_010_0657e-24  # [J/T]

pi = math.pi
inv_sqrt_pi = 1.0 / math.sqrt(math.pi)

# gd = sqrt(doppler_broadening_const_squared * T / m) * f0, m in g/mol
doppler_broadening_const_squared = 2_000.0 * R / (c * c)

standard_gravity = 9.80665  # [m/s^2]
standard_pressure = 101_325.0  # [Pa]
cosmic_microwave_background_temperature = 2.735  # [K]
