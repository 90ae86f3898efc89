"""plan_build_s: the benchmark's span around ``open_filter(...,
eager=True)``, which parses the options, builds the plan (warp maps,
sample spec, prefilter bands, INTER_AREA tables) and its device tables,
with K1's and K4's tile plans (``BlurTables``, ``DeviceArea``).  K3's
tile plan is not in it: the port builds that at the first call, which
set-up prints apart (``first_call_s``).  Layer: plan (``plan.build_plan``
and the device tables ``open_filter`` builds, with the tile plans of K1
and K4).  Moves ``setup_s``.  Host clock."""


def read(run):
    return run.plan_build_s
