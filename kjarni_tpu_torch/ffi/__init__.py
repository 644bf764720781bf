"""The port's C ABI: the JSON bridge (bridge.py) and the build of its shared
library (build.py)."""
