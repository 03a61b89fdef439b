"""Host-clock time of one FDS stats pass (``Trainer.fds_epoch_pass`` or
``fds_epoch_pass_indexed``), synchronized on both sides: the mean over the
window's passes outside the profiled epoch, or the profiled epoch's pass
where the window has no other."""


def read(obs):
    plain = [e["phases"]["fds_pass"] for e in obs.epochs if not e["profiled"]]
    times = plain or [e["phases"]["fds_pass"] for e in obs.epochs]
    return 1e3 * sum(times) / len(times) if times else None
