"""Faults planted in the program, for the checks that must catch them: each
function breaks the timed path in the process that calls it (on a mesh,
each rank calls it) and returns a function that mends it."""


def frozen_state():
    """A step that leaves its state unchanged: Adam takes no step."""
    import torch
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    return lambda: setattr(torch.optim.Adam, "step", step)


def half_batch():
    """Half of the batch left out, the mean taken over the rest."""
    from dino_tracker_tpu_torch.training import train
    sample_batch = train.sample_batch

    def half(*args, **kwargs):
        s = sample_batch(*args, **kwargs)
        return s._replace(**{k: getattr(s, k)[::2] for k in s._fields if k != "frames_set_t"})

    train.sample_batch = half
    return lambda: setattr(train, "sample_batch", sample_batch)


def no_exchange():
    """The gradients' exchange between ranks left out."""
    from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
    from dino_tracker_tpu_torch.training import train
    shim = type(mesh_lib)("mesh_without_exchange")
    shim.__dict__.update(mesh_lib.__dict__)
    shim.all_reduce_grads = lambda model, mesh: None
    train.mesh_lib = shim
    return lambda: setattr(train, "mesh_lib", mesh_lib)


def altered_flow():
    """An answer altered where it is produced: every RAFT flow the program
    decodes shifted by half a pixel in x."""
    from dino_tracker_tpu_torch.models import raft
    decode = raft.raft_decode

    def shifted(*args, **kwargs):
        flow = decode(*args, **kwargs)
        return flow + flow.new_tensor([0.5, 0.0])[None, :, None, None]

    raft.raft_decode = shifted
    return lambda: setattr(raft, "raft_decode", decode)


PROGRAM_FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
                  "no_exchange": no_exchange, "altered_flow": altered_flow}
