"""Timing and energy constants: the simulated accelerator and the card.

Two kinds of constants live here, as in the JAX package's
``repro.core.energy``:

* :class:`HWParams` — the 40 nm ReRAM accelerator the paper simulates
  (the simulator's and the reliability overheads' constants), a verbatim
  copy. Sources (as used by the paper): ISAAC [Shafiee et al., ISCA'16] for
  ReRAM array/ADC/DAC energy and timing, CACTI 6.0 for SRAM, standard DDR3
  figures for DRAM; 40 nm, 1 GHz, DDR3 8 GB/s, a 9 KB buffer, a ReRAM tile
  of 96 IMAs x 8 arrays x 128x128 cells at 2 bits a cell. Where the paper
  is silent: DRAM 20 pJ/bit, SRAM 0.05 pJ/B, a digital int MAC 0.4 pJ, one
  128x128 analog MVM wave 0.1 nJ, 16-bit weights in the MAC baseline and
  8-bit activations everywhere.
* :class:`RooflineParams` — the execution side's roofline, which
  :class:`~repro_torch.core.policy.PlanPolicy`'s cost models read. Its
  default is the H100 SXM's (:data:`DEFAULT_ROOFLINE`); the JAX package's
  TPU constants are kept as :data:`TPU_ROOFLINE`, so that the port's
  ``plan_fused_mlp`` under ``PlanPolicy(hw=TPU_ROOFLINE)`` reproduces the
  reference's TPU dataflow rows.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DEFAULT_HW", "DEFAULT_ROOFLINE", "HWParams", "RooflineParams",
           "TPU_ROOFLINE"]


@dataclass(frozen=True)
class HWParams:
    freq_ghz: float = 1.0
    dram_gbps: float = 8.0              # DDR3, paper §4.1.2
    buffer_bytes: int = 9 * 1024        # paper: 9 KB SRAM

    act_bytes: int = 1                  # int8 activations / feature elements
    weight_bytes: int = 2               # 16-bit weights in the MAC baseline

    # --- MAC-array baseline (MARS-like, 32x32) ---
    mac_width: int = 32                 # 32x32 MACs, 1 tile/cycle

    # --- ReRAM tile (96 IMA x 8 arrays x 128x128 @ 2b/cell) ---
    n_imas: int = 96
    arrays_per_ima: int = 8
    array_rows: int = 128
    array_cols: int = 128
    cell_bits: int = 2
    weight_bits: int = 8                # quantized weights stored in cells
    input_bits: int = 8                 # bit-serial DAC waves per MVM
    # initiation interval in cycles for one input vector through one mapped
    # MLP stage (bit-serial over input_bits, fully pipelined across stages)
    reram_ii_cycles: int = 8

    # --- energy (Joules) ---
    e_dram_per_byte: float = 20e-12 * 8      # 20 pJ/bit
    e_sram_per_byte: float = 0.05e-12
    e_mac: float = 0.4e-12                   # per int MAC, digital @40nm
    e_array_op: float = 0.1e-9               # per 128x128 analog MVM
    e_dig_per_byte: float = 0.1e-12          # digital unit (diff/max/ReLU)
    # ECC scrub: digital Hamming syndrome decode at the shift-add
    # periphery. Charged per protected cell touched by one full scrub
    # pass; throughput bounds the scrub's cycle cost. XOR-tree scale (a
    # few gates per cell at 40 nm) — far below e_mac.
    e_ecc_per_cell: float = 0.05e-12
    ecc_cells_per_cycle: int = 1024
    # static/peripheral power (J/s), charged for the busy duration.
    # ReRAM tile: ~24 mW per IMA idle/peripheral (ISAAC's IMA is 289 mW
    # active; 8 % static is conservative) -> ~2.3 W for 96 IMAs.
    static_w_reram: float = 2.3
    static_w_mac: float = 0.2

    @property
    def n_arrays(self) -> int:
        return self.n_imas * self.arrays_per_ima

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_gbps / self.freq_ghz

    @property
    def cells_per_weight(self) -> int:
        return -(-self.weight_bits // self.cell_bits)  # ceil

    @property
    def weights_per_array(self) -> int:
        """8-bit weights occupy cells_per_weight adjacent 2-bit columns."""
        return self.array_rows * (self.array_cols // self.cells_per_weight)


DEFAULT_HW = HWParams()


@dataclass(frozen=True)
class RooflineParams:
    """Roofline constants of the part that executes the network, as opposed
    to :class:`HWParams` (the simulated 40 nm accelerator). Predicted bytes
    over ``hbm_bytes_per_cycle`` is the memory-bound cycle count, predicted
    multiply-adds over ``mxu_macs_per_cycle`` the compute-bound one; the
    larger is the roofline estimate. ``vmem_bytes`` is the on-chip memory a
    kernel's block is budgeted against, ``sms`` how many multiprocessors
    the Hopper kernels' grids spread over.

    The published figures default to the H100 SXM5's, from NVIDIA's H100
    data sheet and Hopper architecture whitepaper:

    * ``hbm_gbps`` 3350: HBM3 bandwidth, 3.35 TB/s;
    * ``freq_ghz`` 1.83: the boost clock the data sheet's peaks are quoted
      at (132 SMs x 4096 dense int8 MACs a cycle x 2 x 1.83 GHz = 1,979
      TOP/s);
    * ``mxu_macs_per_cycle`` 540672: dense int8 tensor-core multiply-adds
      a cycle over the card, 1,979 TOP/s / 2 / 1.83 GHz = 132 SMs x 4096;
    * ``vmem_bytes`` 233472: shared memory per SM, 228 KB;
    * ``sms`` 132: the SXM5 part's streaming multiprocessors.

    The rest are what the port's hand kernels K1, K2 and K3 take on the
    H100, in cycles at ``freq_ghz``: no data sheet gives them. They are
    fitted (``chip_smoke.py::fit_launch_model``, least squares on the
    relative error) to the device times of the three kernels at every MLP
    of the paper's three models at batch 1 and 8 — 54 times, each the mean
    of three runs of the ``dataflow`` phase of ``chip_smoke.py`` on an H100
    80GB HBM3 at 700 W — and rounded to two digits; they predict those
    times with a root mean square relative error of 7.6%. Each run of that
    phase refits them and prints the fit beside these. They feed
    :meth:`~repro_torch.core.policy.PlanPolicy.launch_cost`:

    * ``launch_cycles``: one more kernel launch on the stream, its grid's
      start and drain;
    * ``slab_cycles``: one block's product of 64 rows x 128 columns x 64
      bytes (``kernels/program.py::LaunchWork.slabs``);
    * ``tile_cycles``: one block's epilogue of 64 x 128 outputs;
    * ``requant_cycles``: one float32 input requantized on load (K1);
    * ``block_overlap``: how many of the blocks an SM holds at once
      progress as one: a launch with ``q`` blocks on its busiest SM takes
      ``max(1, q / block_overlap)`` times one block's time.
    """

    hbm_gbps: float = 3350.0
    freq_ghz: float = 1.83
    vmem_bytes: int = 228 * 1024
    mxu_macs_per_cycle: int = 132 * 4096
    sms: int = 132
    launch_cycles: float = 3800.0
    slab_cycles: float = 1000.0
    tile_cycles: float = 4200.0
    requant_cycles: float = 0.46
    block_overlap: float = 1.5

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_gbps / self.freq_ghz


#: The JAX package's default: a single v4-like TPU core (819 GB/s HBM,
#: 0.94 GHz, 16 MB VMEM, one 128x128 MXU pass a cycle). Used only to
#: reproduce the reference's TPU dataflow choice, which reads no other
#: field.
TPU_ROOFLINE = RooflineParams(hbm_gbps=819.0, freq_ghz=0.94,
                              vmem_bytes=16 * 2 ** 20,
                              mxu_macs_per_cycle=128 * 128, sms=1)

#: The H100's (the defaults above).
DEFAULT_ROOFLINE = RooflineParams()
