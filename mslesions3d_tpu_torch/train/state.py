"""Train state and the reference's optimizer, as plain functions on tensors.

Counterpart of ``mslesions3d_tpu/train/state.py``. The JAX package's
optimizer is ``optax.multi_transform`` of, per group,
``add_decayed_weights(5e-4) -> scale_by_adam(0.9, 0.999, 1e-8) ->
-mult * lr(count)``: L2 decay added to the gradient (torch-Adam semantics,
not decoupled AdamW), every leaf named ``bias`` (BN biases included) at
2x lr, and the schedule read at the optimizer's own count. It is written
here with ``torch._foreach_*`` ops rather than ``torch.optim.Adam``, which
would skip a parameter whose gradient is None (``rescale_factors`` has a
zero gradient while ``use_l2_rescale`` is off, and L2 decay still moves
it), and whose scheduler would count the steps a non-finite loss skipped.

Schedulers: "CosineAnnealingLR" (stepped every step with period 2 x t_max,
the reference's quirk), "cosine_annealed" (one half-cosine over t_max steps,
then held at 0) and "none".

The state keeps float32 master parameters under the model's parameter
names; the forward runs on them rounded to the compute dtype, so a bf16
gradient reaches them upcast, as the JAX package's cast at use does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.ssd3d import SSD3D, SSD3DConfig

SCHEDULERS = ("CosineAnnealingLR", "cosine_annealed", "none")
# scale_by_adam's constants and the bias group's lr multiplier, as the JAX
# package's make_optimizer fixes them
B1, B2, EPS = 0.9, 0.999, 1e-8
BIAS_MULT = 2.0


def cosine_annealing_schedule(base_lr: float, t_max: int = 40, eta_min: float = 0.0):
    """torch's CosineAnnealingLR in closed form, periodic past t_max; takes
    an integer count tensor and returns float32."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.cos(math.pi * count.float() / t_max)
        return eta_min + (base_lr - eta_min) * (1 + c) / 2

    return schedule


def is_bias(name: str) -> bool:
    """The 2x-lr group: every parameter named ``bias`` (conv and BN biases)."""
    return name.rsplit(".", 1)[-1] == "bias"


@dataclasses.dataclass(frozen=True)
class AdamState:
    count: torch.Tensor  # int32, the updates applied (a skipped step does not count)
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamL2:
    """Adam with L2 decay added to the gradient, a 2x-lr bias group and a
    schedule read at the optimizer's count."""

    lr: float
    scheduler: str = "CosineAnnealingLR"
    weight_decay: float = 5e-4
    t_max: int = 40

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"Unknown scheduler {self.scheduler!r}; known: {SCHEDULERS}")

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The base learning rate at an update count (float32 tensor)."""
        if self.scheduler == "none":
            return torch.full_like(count, self.lr, dtype=torch.float32)
        periodic = cosine_annealing_schedule(self.lr, self.t_max)
        if self.scheduler == "cosine_annealed":
            count = torch.clamp(count, max=self.t_max)
        return periodic(count)

    def init(self, params: dict) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    def update(self, grads: dict, state: AdamState, params: dict) -> tuple[dict, AdamState]:
        """One step: returns (new params, new state); nothing is modified in place."""
        names = list(params)
        p = [params[n] for n in names]
        g = torch._foreach_add([grads[n] for n in names], p, alpha=self.weight_decay)
        mu = torch._foreach_mul([state.mu[n] for n in names], B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        nu = torch._foreach_mul([state.nu[n] for n in names], B2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - B2)
        count_inc = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - B1 ** count_inc.float())
        nu_hat = torch._foreach_div(nu, 1 - B2 ** count_inc.float())
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
        updates = torch._foreach_div(mu_hat, denom)
        lr = self.schedule(state.count)
        for group, mult in ((False, 1.0), (True, BIAS_MULT)):
            idx = [i for i, n in enumerate(names) if is_bias(n) == group]
            if idx:
                torch._foreach_mul_([updates[i] for i in idx], -mult * lr)
        new_p = torch._foreach_add(p, updates)
        return dict(zip(names, new_p)), AdamState(
            count=count_inc, mu=dict(zip(names, mu)), nu=dict(zip(names, nu)))


def make_optimizer(lr: float, scheduler: str = "CosineAnnealingLR",
                   weight_decay: float = 5e-4, t_max: int = 40):
    """(optimizer, base schedule), as the JAX package's ``make_optimizer``."""
    tx = AdamL2(lr, scheduler, weight_decay, t_max)
    return tx, tx.schedule


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: torch.Tensor  # int32; advances on every step, skipped or not
    params: dict  # float32 masters, by the model's parameter names
    batch_stats: dict  # BN running_mean / running_var, by buffer name
    opt_state: AdamState
    nonfinite_streak: torch.Tensor  # int32, consecutive non-finite losses
    ema_params: dict | None  # None when config.ema_decay == 0
    tx: AdamL2

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.step.device

    def apply_gradients(self, grads: dict, new_batch_stats: dict | None = None) -> "TrainState":
        params, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1, params=params, opt_state=opt_state,
            batch_stats=self.batch_stats if new_batch_stats is None else new_batch_stats,
        )

    def state_dict(self) -> dict:
        """The served model's ``state_dict`` (the reference schema): the
        params, rounded by ``load_state_dict`` to the model's storage, and
        the BN statistics."""
        out = {**self.params, **self.batch_stats}
        for key in [k for k in self.batch_stats if k.endswith(".running_var")]:
            out[key.replace(".running_var", ".num_batches_tracked")] = torch.zeros(
                (), dtype=torch.long, device=self.device)
        return out


def eval_view(state: TrainState) -> TrainState:
    """The state that validation and predict score: the EMA params when carried."""
    if state.ema_params is None:
        return state
    return state.replace(params=state.ema_params)


def resolve_device(device, caller: str = "create_train_state") -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: no CUDA device is available; pass device='cpu' (--device cpu on "
            "the command line) to run on the CPU"
        )
    return device


def use_ieee_float32() -> None:
    """Run float32 convolutions and matmuls in IEEE float32: TF32 off for
    cuDNN and cuBLAS (torch leaves cuDNN's TF32 on by default). A config's
    ``dtype="float32"`` means this; bfloat16 compute is unaffected. The
    entry points that run the model (cli.train, cli.predict, cli.tune_lr)
    call it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def create_train_state(config: SSD3DConfig, seed: int = 0, device="cuda",
                       state_dict: dict | None = None) -> TrainState:
    """Initial state for ``config`` on ``device`` (the card unless asked).

    Weights come from ``state_dict`` (the reference schema, e.g. from
    ``weights.from_jax_variables``) or, if it is None, from
    ``config.init_scheme`` drawn by a generator seeded with ``seed``. The
    masters are float32 whatever ``config.dtype``: the init draws float32
    values, and the compute dtype rounds them only at use. 5-D weights are
    kept ``channels_last_3d``, the model's layout. EMA, when on, starts at
    the initial params.
    """
    device = resolve_device(device)
    master = SSD3D(dataclasses.replace(config, dtype="float32"),
                   generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        master.load_state_dict(state_dict)
    master = master.to(device, memory_format=torch.channels_last_3d)
    params = {n: p.detach().clone() for n, p in master.named_parameters()}
    batch_stats = {n: b.detach().clone() for n, b in master.named_buffers()
                   if not n.endswith("num_batches_tracked")}
    tx, _ = make_optimizer(config.lr, config.scheduler, t_max=config.t_max)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(
        step=zero, params=params, batch_stats=batch_stats, opt_state=tx.init(params),
        nonfinite_streak=zero.clone(),
        ema_params={n: p.clone() for n, p in params.items()} if config.ema_decay > 0 else None,
        tx=tx,
    )
