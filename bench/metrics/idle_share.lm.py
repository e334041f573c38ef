"""Share of the traced window in which no operation ran on the device,
in the LM cells (`bench/README.md` says why each group has a name)."""
from bench.lib.trace import idle_share as read  # noqa: F401
