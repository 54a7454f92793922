"""Physical constants used throughout (no scipy dependency in hot paths)."""

LIGHTSPEED = 299792458.0  # m/s, exact
