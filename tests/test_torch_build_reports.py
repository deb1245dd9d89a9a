"""The readers of the kernel build's reports (``-Xptxas -v`` and
``cuobjdump -sass``), on fixed listings in the tools' formats: they run
on the CPU, while the reports themselves come from ``nvcc`` on a GPU
machine (``chip_smoke.py`` phase 1)."""
from repro_torch.kernels.build import ptxas_kernels, sass_mix
from _torch_threads import one_torch_thread  # noqa: F401

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6blocksPKj' for 'sm_90a'
ptxas info    : Function properties for _Z6blocksPKj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 39 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z7enclavePKj' for 'sm_90a'
ptxas info    : Function properties for _Z7enclavePKj
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""

SASS = """
\tcode for sm_90a
\t\tFunction : _Z6blocksPKj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;         /* 0x0000000000007919 */
        /*0020*/                   IMAD.MOV.U32 R3, RZ, RZ, RZ ;
        /*0030*/              @!P0 IADD3 R2, R2, R3, RZ ;
        /*0040*/                   SHF.L.W.U32.HI R5, R4, 0x10, R4 ;
        /*0050*/                   LOP3.LUT R5, R5, R2, RZ, 0x3c, !PT ;
        /*0060*/                   ULDC.64 UR4, c[0x0][0x208] ;
        /*0070*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0080*/                   EXIT ;
.L_x_0:
        /*0090*/                   BRA `(.L_x_0);
        /*00a0*/                   NOP;
\t\tFunction : _Z4loopPKj
.L_x_1:
        /*0000*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0010*/               @P0 BRA `(.L_x_1) ;
        /*0020*/                   EXIT ;
.L_x_2:
        /*0030*/                   BRA `(.L_x_2);
"""


def test_ptxas_kernels_reads_registers_and_spills():
    got = [(k["name"], k["registers"], k["spill_stores"], k["spill_loads"])
           for k in ptxas_kernels(PTXAS)]
    assert got == [("_Z6blocksPKj", 39, 0, 0), ("_Z7enclavePKj", 255, 8, 4)]


def test_sass_mix_counts_pipes_and_finds_loops():
    blocks, loop = sass_mix(SASS)
    assert blocks["name"] == "_Z6blocksPKj"
    # IADD3, SHF, LOP3 on the ALU pipe; the IMAD on the FP32 lanes; the
    # NOP padding is not counted; the closing self-branch is no loop
    assert {k: blocks[k] for k in ("alu", "fma", "uniform", "mem",
                                   "control", "loops")} == \
        {"alu": 3, "fma": 1, "uniform": 1, "mem": 2, "control": 3,
         "loops": False}
    assert blocks["ops"]["IMAD.MOV.U32"] == 1 and "NOP" not in blocks["ops"]
    assert loop["name"] == "_Z4loopPKj" and loop["loops"]
    assert (loop["alu"], loop["control"]) == (1, 3)
