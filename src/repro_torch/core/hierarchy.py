"""MemoryHierarchy — the N-tier, medium-described memory hierarchy API.

The paper schedules "the entire memory hierarchy ... simultaneously";
this module is the first-class description of that hierarchy: an ordered
list of tiers (fastest first), each a :class:`MediumSpec` naming its
capacity, its Table-1 cost-model medium (latency / energy / endurance),
its residency (device torch pool, host numpy pool, or pinned host memory
the card addresses in place), and its telemetry flags (wear tracking,
Start-Gap leveling, int8 soft-NVM storage).

Everything above this module is generic over tier *indices*: the
placement policy scores pages against per-tier ``MediumSpec`` costs, the
sub-buddy allocator and Algorithm-2 slot targeting run per tier, the
migration engines move pages between arbitrary tier pairs, and the
wear/energy telemetry attaches to every tier whose spec sets
``wear_tracked`` — nothing outside the compatibility shim below names a
"fast" or "slow" tier.

Conventions:

  * tier 0 is the fastest tier and is the tier compute reads from (the
    serving engine's block tables only ever point at tier-0 slots);
  * tiers are ordered fastest -> slowest; "promotion" moves a page to a
    lower tier index, "demotion" to a higher one;
  * device tiers hold one torch tensor pool each (HBM, or an HBM-resident
    DRAM-channel simulation); host tiers hold numpy pools (the NVM/CXL
    analogue); pinned-host tiers hold one pinned host tensor the kernels
    read and write in place (the paper's byte-addressable NVM).  Only
    host-class tiers support wear tracking, Start-Gap leveling, and int8
    quantization.

Compatibility shim
------------------
The pre-redesign API hardcoded exactly two tiers through module-level
``FAST = 0`` / ``SLOW = 1`` constants.  Those constants now live *only*
here, next to :meth:`MemoryHierarchy.two_tier` — the constructor that
reproduces the old fast/slow behavior bit for bit (pinned by
``tests/test_hierarchy.py::test_two_tier_parity_vs_golden``).  New code
should carry tier indices instead of importing them.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from . import costmodel as cm

# --- two-tier compatibility shim ---------------------------------------------
# The only surviving FAST/SLOW constants.  They are exactly the tier
# indices of a ``MemoryHierarchy.two_tier(...)`` hierarchy; in an N-tier
# hierarchy "fast" is tier 0 and "slow" is the deepest tier.
FAST = 0  # fastest tier of a two_tier() hierarchy (DRAM / HBM analogue)
SLOW = 1  # deepest tier of a two_tier() hierarchy (NVM / host analogue)

DEVICE = "device"   # torch tensor pool on the card (HBM-resident)
HOST = "host"       # numpy pool (host DRAM; the NVM-channel analogue)
PINNED_HOST = "pinned_host"  # pinned host memory the card addresses


@dataclass(frozen=True)
class MediumSpec:
    """One tier of the hierarchy, described by its physical medium.

    ``medium`` supplies the Table-1 cost model (read/write latency and
    energy, standby power, endurance); ``slots`` is the pool capacity in
    pages; ``bandwidth_gbps`` is the channel's peak bandwidth for the
    bandwidth balancer (0 = unmodeled).  ``wear_tracked`` attaches the
    per-physical-slot write counters of ``repro_torch.nvm`` to this tier;
    ``wear_leveling`` adds Start-Gap rotation on top.  ``quantize_int8``
    stores pages as int8 + per-page scale (the soft-NVM read-cheap /
    write-lossy analogue).  Wear, leveling, and quantization are
    host-class features: they require ``residency == "host"`` or
    ``residency == "pinned_host"``.

    ``pinned_host`` is the NVM/CXL analogue with device addressability:
    the serving engine attends to and appends into its pages in place.
    ``quantize_int8`` tiers are served by this package's ``TierStore``
    (numpy host or pinned host; demotions quantize with kernel K6,
    promotions dequantize with ``dequant_gather``); it refuses only a
    hierarchy with more than one int8 tier, with ``NotImplementedError``.
    """

    name: str
    slots: int
    medium: cm.MediumParams
    residency: str = HOST
    bandwidth_gbps: float = 0.0
    wear_tracked: bool = False
    wear_leveling: bool = False
    gap_write_interval: int | None = None   # None -> costmodel 95% target
    quantize_int8: bool = False

    def __post_init__(self):
        if self.residency not in (DEVICE, HOST, PINNED_HOST):
            raise ValueError(f"residency must be '{DEVICE}', '{HOST}' or "
                             f"'{PINNED_HOST}', got {self.residency!r}")
        if self.slots < 1:
            raise ValueError(f"tier {self.name!r} needs at least 1 slot")
        if self.residency == DEVICE and (self.wear_tracked
                                         or self.wear_leveling
                                         or self.quantize_int8):
            raise ValueError(
                f"tier {self.name!r}: wear tracking / leveling / int8 "
                "quantization are host-class features (the device pool is "
                "touched inside jitted steps with no accounting hook; "
                "pinned_host tiers support them)")
        if self.wear_leveling and not self.wear_tracked:
            raise ValueError(f"tier {self.name!r}: wear_leveling requires "
                             "wear_tracked")

    @property
    def is_device(self) -> bool:
        return self.residency == DEVICE

    @property
    def is_pinned(self) -> bool:
        return self.residency == PINNED_HOST

    @property
    def is_device_addressable(self) -> bool:
        """Whether kernels can gather/scatter this tier's pool directly
        (device tiers and pinned-host tiers)."""
        return self.residency in (DEVICE, PINNED_HOST)

    def read_cost_ns(self) -> float:
        return cm.access_latency_ns(self.medium, is_write=False)

    def write_cost_ns(self) -> float:
        return cm.access_latency_ns(self.medium, is_write=True)


@dataclass(frozen=True)
class MemoryHierarchy:
    """An ordered (fastest -> slowest) list of :class:`MediumSpec` tiers."""

    tiers: tuple[MediumSpec, ...]

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError("a MemoryHierarchy needs at least 2 tiers")
        object.__setattr__(self, "tiers", tuple(self.tiers))

    # -- container protocol ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.tiers)

    def __iter__(self):
        return iter(self.tiers)

    def __getitem__(self, i: int) -> MediumSpec:
        return self.tiers[i]

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def deepest(self) -> int:
        """Index of the slowest tier (the default residence of new pages)."""
        return len(self.tiers) - 1

    # -- tier subsets ---------------------------------------------------------
    def device_tiers(self) -> list[int]:
        return [i for i, t in enumerate(self.tiers) if t.is_device]

    def host_tiers(self) -> list[int]:
        return [i for i, t in enumerate(self.tiers) if not t.is_device]

    def pinned_tiers(self) -> list[int]:
        return [i for i, t in enumerate(self.tiers) if t.is_pinned]

    def wear_tiers(self) -> list[int]:
        return [i for i, t in enumerate(self.tiers) if t.wear_tracked]

    def total_slots(self) -> int:
        return sum(t.slots for t in self.tiers)

    def describe(self) -> str:
        return " -> ".join(f"{t.name}[{t.slots}{'*' if t.is_device else ''}]"
                           for t in self.tiers)

    # -- canonical constructors ----------------------------------------------
    @classmethod
    def two_tier(cls, fast_slots: int, slow_slots: int, *,
                 quantize_slow: bool = False, track_wear: bool = True,
                 wear_leveling: bool = True,
                 gap_write_interval: int | None = None,
                 pinned_slow: bool = False) -> "MemoryHierarchy":
        """The pre-redesign FAST/SLOW pair: a device HBM tier over a host
        NVM-analogue tier.  Behaviorally bit-identical to the old
        hardcoded ``TierStore`` (parity-pinned against a golden trace).
        ``pinned_slow`` makes the NVM tier pinned host memory, served in
        place by the dual-pool decode."""
        return cls(tiers=(
            MediumSpec("HBM", fast_slots, cm.HBM, residency=DEVICE),
            MediumSpec("NVM", slow_slots, cm.NVM,
                       residency=PINNED_HOST if pinned_slow else HOST,
                       wear_tracked=track_wear,
                       wear_leveling=track_wear and wear_leveling,
                       gap_write_interval=gap_write_interval,
                       quantize_int8=quantize_slow),
        ))

    @classmethod
    def three_tier(cls, hbm_slots: int, dram_slots: int, nvm_slots: int, *,
                   quantize_nvm: bool = False, track_wear: bool = True,
                   wear_leveling: bool = True,
                   gap_write_interval: int | None = None,
                   pinned_nvm: bool = False) -> "MemoryHierarchy":
        """The HBM -> DRAM -> NVM demo hierarchy: a second device-resident
        pool simulates the DRAM channel (device<->device migration stays
        on-accelerator), backed by the host NVM-analogue tier with wear
        telemetry.  ``pinned_nvm`` makes the NVM tier pinned host
        memory."""
        return cls(tiers=(
            MediumSpec("HBM", hbm_slots, cm.HBM, residency=DEVICE),
            MediumSpec("DRAM", dram_slots, cm.DRAM, residency=DEVICE),
            MediumSpec("NVM", nvm_slots, cm.NVM,
                       residency=PINNED_HOST if pinned_nvm else HOST,
                       wear_tracked=track_wear,
                       wear_leveling=track_wear and wear_leveling,
                       gap_write_interval=gap_write_interval,
                       quantize_int8=quantize_nvm),
        ))

    def with_tier(self, i: int, **changes) -> "MemoryHierarchy":
        """A copy with tier ``i`` replaced (dataclasses.replace semantics)."""
        tiers = list(self.tiers)
        tiers[i] = replace(tiers[i], **changes)
        return MemoryHierarchy(tiers=tuple(tiers))
