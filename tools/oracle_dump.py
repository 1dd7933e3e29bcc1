"""Stage-dump instrumented build of the reference encoder (test only).

Copies the reference encoder sources into ``.oracle/src_enc`` (gitignored,
never committed), inserts raw-binary dump hooks at pipeline stage
boundaries, and builds ``nhw-enc-dump``.  Running it with
``NHW_DUMP_DIR=<dir>`` writes one ``<stage>.bin`` per hook, which the test
suite uses to validate each device encoder stage in isolation
(SURVEY.md section 4: stage-level goldens).

The patcher anchors on exact source substrings; occurrence indices select
between repeated anchors (0-based, counted after earlier insertions).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

import oracle

SRC = oracle.ORACLE_DIR / "src_enc"
BIN = oracle.BIN / "nhw-enc-dump"

_DUMP_HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
static void nhw_dump(const char*name, const void*p, long bytes){
  const char*d=getenv("NHW_DUMP_DIR"); if(!d) return;
  char path[1024]; snprintf(path,sizeof path,"%s/%s.bin",d,name);
  FILE*f=fopen(path,"wb"); if(!f) return; fwrite(p,1,bytes,f); fclose(f);
}
static void nhw_trace(const int*v, int n){
  static FILE*tf; const char*d=getenv("NHW_DUMP_DIR"); if(!d) return;
  if(!tf){char p[1024];snprintf(p,sizeof p,"%s/trace.bin",d);tf=fopen(p,"wb");}
  fwrite(v,4,n,tf); fflush(tf);
}
"""

# (filename, occurrence, anchor, where, code) — where: "after" | "before"
_HOOKS = [
    ("image_processing.c", 0,
     "if (lower_quality_setting_on)\n\t\t\t{\n\t\t\t\tif (abs(res)>4 && abs(res)<n1)",
     "before",
     '{int _tv[12]={t1,t4,t6,t44,t8,w8,t17,t7,t19,t20,t21,t23};nhw_trace(_tv,12);}\n\t\t\t'),
    ("image_processing.c", 0,
     "if (im->setup->quality_setting<=LOW4) nhw_sharp_on", "before",
     'nhw_dump("dpre0_kernel", nhw_kernel, 4*IM_SIZE*2);\n\t'),
    ("image_processing.c", 0,
     "for (i=(2*IM_DIM),t1=0,t2=0,t3=0,t4=0,t5=0,t6=0;", "before",
     'nhw_dump("dpre1_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("dpre1_kernel", nhw_kernel, 4*IM_SIZE*2);\n\t\t'),
    ("image_processing.c", 0,
     "\t\tfor (i=(2*IM_DIM);i<((4*IM_SIZE)-(2*IM_DIM));i+=(2*IM_DIM))",
     "before",
     '\tnhw_dump("dpre2_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("dpre2_kernel", nhw_kernel, 4*IM_SIZE*2);'
     'nhw_dump("dpre2_sharp", nhw_sharp_on, 4*IM_SIZE);\n\t'),
    ("colorspace.c", 0, "free(im->im_buffer4);", "before",
     'nhw_dump("d1_y", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("d1_u", im->im_bufferU, IM_SIZE);'
     'nhw_dump("d1_v", im->im_bufferV, IM_SIZE);'),
    ("nhw_encoder.c", 0, "end_transform=0;\n\twavelet_order", "before",
     'nhw_dump("d2_jpeg", im->im_jpeg, 4*IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 0,
     "wavelet_analysis(im,(2*IM_DIM),end_transform++,1);", "after",
     '\n\tnhw_dump("d3_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("d3_process", im->im_process, 4*IM_SIZE*2);'),
    ("nhw_encoder.c", 0,
     "wavelet_analysis(im,(2*IM_DIM)>>1,end_transform,1);", "after",
     '\n\tnhw_dump("d4_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("d4_process", im->im_process, 4*IM_SIZE*2);'),
    ("nhw_encoder.c", 0, "offsetY_recons256(im,enc,ratio,1);", "after",
     '\n\tnhw_dump("dq1_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("dq1_process", im->im_process, 4*IM_SIZE*2);'),
    ("nhw_encoder.c", 0,
     "wavelet_synthesis(im,(2*IM_DIM)>>1,end_transform-1,1);", "after",
     '\n\tnhw_dump("dq2_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("dq2_process", im->im_process, 4*IM_SIZE*2);'),
    ("nhw_encoder.c", 1,
     "wavelet_analysis(im,(2*IM_DIM)>>1,end_transform,1);", "before",
     'nhw_dump("dqneg_res256", res256-8, 16);'
     'nhw_dump("dqneg_process", ((short*)im->im_process)-8, 16);'
     'nhw_dump("dq3_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("dq3_process", im->im_process, 4*IM_SIZE*2);'
     'nhw_dump("dq3_res256", res256, IM_SIZE*2);\n\t'),
    # end of the requant feedback block (second analysis at its tail)
    ("nhw_encoder.c", 1,
     "wavelet_analysis(im,(2*IM_DIM)>>1,end_transform,1);", "after",
     '\n\tnhw_dump("d5_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("d5_process", im->im_process, 4*IM_SIZE*2);'
     'nhw_dump("d5_res256", res256, IM_SIZE*2);'),
    # after cleanup ladders, at the resIII snapshot
    ("nhw_encoder.c", 0, "resIII=(short*)malloc(IM_SIZE*sizeof(short));",
     "before",
     'nhw_dump("d6_process", im->im_process, 4*IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 0, "enc->nhw_res1_word_len=0;", "before",
     'nhw_dump("d16_res256", res256, IM_SIZE*2);'
     'nhw_dump("d16_oob", res256+IM_SIZE, 1024);'
     'nhw_dump("d16_process", im->im_process, 4*IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 0,
     "highres=(unsigned char*)malloc(((96*IM_DIM)+1)*sizeof(char));", "before",
     'nhw_dump("d17_res256", res256, IM_SIZE*2);'
     'nhw_dump("d17_process", im->im_process, 4*IM_SIZE*2);\n\t'),
    # after LL2 byte-coding + exw escapes
    ("nhw_encoder.c", 0, "Y_highres_compression(im,enc);", "before",
     'nhw_dump("d7_tree1", enc->tree1, 16384);nhw_dump("d7_tree1oob", enc->tree1+16384, 64);'
     'nhw_dump("d7_exw", enc->exw_Y, enc->exw_Y_end);'
     'nhw_dump("d7_res4", enc->nhw_res4, im->setup->quality_setting>LOW3 ? enc->nhw_res4_len : 0);'
     'nhw_dump("d7_chres", enc->ch_res, 16384);'
     'nhw_dump("d7_process", im->im_process, 4*IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 0, "Y_highres_compression(im,enc);", "after",
     '\n\tnhw_dump("d8_hrcomp", enc->highres_comp, enc->Y_res_comp);'
     'nhw_dump("d8_hrmem", enc->highres_mem, enc->highres_mem_len*2);'
     'nhw_dump("d8_hrword", enc->highres_word, enc->highres_comp_len);'
     '{int v=im->setup->RES_LOW;nhw_dump("d8_reslow", &v, 4);}'
     '{int v=enc->Y_res_comp;nhw_dump("d8_yrescomp", &v, 4);}'),
    # after requant part=0 + synthesis (im_jpeg holds the synthesized plane)
    ("nhw_encoder.c", 0, "free(im->im_jpeg);", "before",
     'nhw_dump("d9_jpeg", im->im_jpeg, 4*IM_SIZE*2);'
     'nhw_dump("d9_resIIIoob", resIII+IM_SIZE, 512);\n\t'),
    # after all Y band cleanup, before quantization
    ("nhw_encoder.c", 0, "offsetY(im,ratio);", "before",
     'nhw_dump("d10_process", im->im_process, 4*IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 0, "offsetY(im,ratio);", "after",
     '\n\tnhw_dump("d11_process", im->im_process, 4*IM_SIZE*2);'),
    # Y serpentine + fixups done (start of U section)
    ("nhw_encoder.c", 0, "// U", "after",
     '\n\tnhw_dump("d12_imnhw", im->im_nhw, 4*IM_SIZE);'
     '{int v=enc->nhw_select1;nhw_dump("d12_sel1", &v, 4);}'
     '{int v=enc->nhw_select2;nhw_dump("d12_sel2", &v, 4);}'),
    # U plane before/after quantization
    ("nhw_encoder.c", 0, "offsetUV(im,ratio);", "before",
     'nhw_dump("d13u_process", im->im_process, IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 0, "offsetUV(im,ratio);", "after",
     '\n\tnhw_dump("d14u_process", im->im_process, IM_SIZE*2);'),
    ("nhw_encoder.c", 1, "offsetUV(im,ratio);", "before",
     'nhw_dump("d13v_process", im->im_process, IM_SIZE*2);\n\t'),
    ("nhw_encoder.c", 1, "offsetUV(im,ratio);", "after",
     '\n\tnhw_dump("d14v_process", im->im_process, IM_SIZE*2);'),
    # process plane right after offsetY_recons256 part=0
    ("nhw_encoder.c", 0, "offsetY_recons256(im,enc,ratio,0);", "after",
     '\n\tnhw_dump("dP0_process", im->im_process, 4*IM_SIZE*2);'
     'nhw_dump("dP0_jpeg", im->im_jpeg, 4*IM_SIZE*2);'),
    # HQ residue (q>HIGH1) mark-state + inputs
    ("wavelet_filterbank.c", 0, "free(im->im_quality_setting);", "before",
     'nhw_dump("dHQ_whs", wavelet_half_synthesis, 2*IM_SIZE*2);'
     'nhw_dump("dHQ_snap", im->im_quality_setting, 2*IM_SIZE*2);\n\t'),
    ("wavelet_filterbank.c", 0,
     "if (im->setup->quality_setting>HIGH2) wavelet_half_synth_res=30;",
     "before",
     'nhw_dump("dHQ_synth", wavelet_half_synthesis, 2*IM_SIZE*2);'
     'nhw_dump("dHQ_wfo", im->im_wavelet_first_order, IM_SIZE*2);'
     'nhw_dump("dHQ_band", im->im_wavelet_band, IM_SIZE*2);\n\t'),
    # im_nhw immediately before the packetizer
    ("nhw_encoder.c", 0, "\n\twavlts2packet(im,enc);", "before",
     '\n\tnhw_dump("dPKT_imnhw", im->im_nhw, 6*IM_SIZE);'),
    # U sentinel-marking entry + the res256 OOB region it can drift into
    ("nhw_encoder.c", 0,
     "if (im->setup->quality_setting>=LOW2)\n\t{ \n\tfor (i=0,count=0,Y=0,e=0;i<(IM_SIZE>>1);i+=IM_DIM)",
     "before",
     'nhw_dump("dU2_res256oob", res256+(IM_SIZE>>2), 128);\n\t'),
    ("nhw_encoder.c", 1,
     "if (im->setup->quality_setting>=LOW2)\n\t{ \n\tfor (i=0,count=0,Y=0,e=0;i<(IM_SIZE>>1);i+=IM_DIM)",
     "before",
     'nhw_dump("dV3_res256oob", res256+(IM_SIZE>>2), 128);\n\t'),
    # V sentinel-marking entry (occurrence 1 = V section)
    ("nhw_encoder.c", 1,
     "if (im->setup->quality_setting>=LOW2)\n\t{ \n\tfor (i=0,count=0,Y=0,e=0;i<(IM_SIZE>>1);i+=IM_DIM)",
     "before",
     'nhw_dump("dV2_process", im->im_process, IM_SIZE*2);'
     'nhw_dump("dV2_res256", res256, (IM_SIZE>>2)*2);'
     'nhw_dump("dV2_jpeg", im->im_jpeg, IM_SIZE*2);\n\t'),
    # res256 slack writer trace
    ("nhw_encoder.c", 0, "offsetY_recons256(im,enc,ratio,1);", "before",
     'nhw_dump("dS1_oob", res256+IM_SIZE, 16);\n\t'),
    ("nhw_encoder.c", 0, "offsetY_recons256(im,enc,ratio,1);", "after",
     '\n\tnhw_dump("dS2_oob", res256+IM_SIZE, 16);'),
    ("nhw_encoder.c", 0, "wavelet_synthesis(im,(2*IM_DIM)>>1,end_transform-1,1);",
     "after", '\n\tnhw_dump("dS3_oob", res256+IM_SIZE, 16);'),
    # full kernel buffer at free time (automaton cross-check)
    ("image_processing.c", 0, "free(nhw_kernel);", "before",
     'nhw_dump("dK_kernel", nhw_kernel, 4*IM_SIZE*2);\n\t'),
    # slack-origin traces: the 32KB chunks' tail region at each malloc
    ("nhw_encoder.c", 0, "res256=(short*)malloc((IM_SIZE>>2)*sizeof(short));",
     "after", '\n\tnhw_dump("dU_res256oob_at_malloc", res256+(IM_SIZE>>2), 64);'),
    ("nhw_encoder.c", 1, "res256=(short*)malloc((IM_SIZE>>2)*sizeof(short));",
     "after", '\n\tnhw_dump("dV_res256oob_at_malloc", res256+(IM_SIZE>>2), 64);'),
    ("image_processing.c", 0,
     "highres_tmp=(short*)malloc((IM_SIZE>>2)*sizeof(short));",
     "after", '\n\t\tnhw_dump("dHT_oob_at_malloc", highres_tmp+(IM_SIZE>>2), 64);'),
    # V compare-ladder entry: process plane + res256 incl. its OOB short
    ("nhw_encoder.c", 0, "for (i=0,count=0,a=0,Y=0;i<(IM_SIZE>>1);i+=IM_DIM)",
     "before",
     'nhw_dump("dV_process", im->im_process, IM_SIZE*2);'
     'nhw_dump("dV_res256", res256, (IM_SIZE>>2)*2);'
     'nhw_dump("dV_res256oob", res256+(IM_SIZE>>2), 64);\n\t'),
    # resIII OOB alias at the <LOW6 cleanup entry (nhw_encoder.c:871)
    ("nhw_encoder.c", 0, "for (i=0;i<(2*IM_SIZE);i+=(2*IM_DIM))", "before",
     'nhw_dump("dLL_resIIIoob", resIII+IM_SIZE, 256);\n\t\t'),
    ("nhw_encoder.c", 0, "\n\thighres_compression(im,enc);", "before",
     '\n\tnhw_dump("d15_imnhw", im->im_nhw, 6*IM_SIZE);'
     'nhw_dump("d15_tree1", enc->tree1, 24576);'),
]


def build() -> Path:
    if BIN.exists():
        return BIN
    if SRC.exists():
        shutil.rmtree(SRC)
    SRC.mkdir(parents=True)
    for p in (oracle.REFERENCE / "encoder").iterdir():
        shutil.copy(p, SRC / p.name)

    patched = {}
    for fname, occ, anchor, where, code in _HOOKS:
        path = SRC / fname
        text = patched.get(fname, path.read_text())
        idx = -1
        for _ in range(occ + 1):
            idx = text.index(anchor, idx + 1)
        at = idx + len(anchor) if where == "after" else idx
        text = text[:at] + code + text[at:]
        patched[fname] = text
    for fname, text in patched.items():
        (SRC / fname).write_text(_DUMP_HELPER + text)

    srcs = sorted(str(p) for p in SRC.glob("*.c"))
    oracle.BIN.mkdir(parents=True, exist_ok=True)
    subprocess.run(["gcc", "-O2", "-o", str(BIN), *srcs, "-lm"], check=True)
    return BIN


def run(bmp: Path, q: int, dump_dir: Path) -> Path:
    """Encode with dumps; returns the .nhw path (written next to dumps)."""
    enc = build()
    dump_dir.mkdir(parents=True, exist_ok=True)
    out = dump_dir / "out.nhw"
    env = dict(os.environ, NHW_DUMP_DIR=str(dump_dir))
    subprocess.run([str(enc), f"-q{q}", "-f", str(bmp), str(out)],
                   check=True, capture_output=True, env=env)
    return out


_DTYPES = {
    "dpre0_kernel": ("<i2", (512, 512)),
    "dpre1_jpeg": ("<i2", (512, 512)), "dpre1_kernel": ("<i2", (512, 512)),
    "dpre2_jpeg": ("<i2", (512, 512)), "dpre2_kernel": ("<i2", (512, 512)),
    "dpre2_sharp": ("u1", None),
    "d1_y": ("<i2", (512, 512)), "d1_u": ("u1", (256, 256)),
    "d1_v": ("u1", (256, 256)),
    "d2_jpeg": ("<i2", (512, 512)),
    "d3_jpeg": ("<i2", (512, 512)), "d3_process": ("<i2", (512, 512)),
    "d4_jpeg": ("<i2", (512, 512)), "d4_process": ("<i2", (512, 512)),
    "dq1_jpeg": ("<i2", (512, 512)), "dq1_process": ("<i2", (512, 512)),
    "dq2_jpeg": ("<i2", (512, 512)), "dq2_process": ("<i2", (512, 512)),
    "dq3_jpeg": ("<i2", (512, 512)), "dq3_process": ("<i2", (512, 512)),
    "dq3_res256": ("<i2", (256, 256)),
    "dqneg_res256": ("<i2", None), "dqneg_process": ("<i2", None),
    "d5_jpeg": ("<i2", (512, 512)), "d5_process": ("<i2", (512, 512)),
    "d5_res256": ("<i2", (256, 256)),
    "d6_process": ("<i2", (512, 512)),
    "d7_tree1": ("u1", (128, 128)), "d7_tree1oob": ("u1", None),
    "d7_exw": ("u1", None),
    "d7_res4": ("u1", None), "d7_chres": ("u1", (128, 128)),
    "d7_process": ("<i2", (512, 512)),
    "d8_hrcomp": ("u1", None), "d8_hrmem": ("<u2", None),
    "d8_hrword": ("u1", None), "d8_reslow": ("<i4", None),
    "d8_yrescomp": ("<i4", None),
    "d9_jpeg": ("<i2", (512, 512)), "d9_resIIIoob": ("<i2", None),
    "dLL_resIIIoob": ("<i2", None),
    "dV_process": ("<i2", (256, 256)), "dV_res256": ("<i2", (128, 128)),
    "dV_res256oob": ("<i2", None),
    "dPKT_imnhw": ("u1", None),
    "dU2_res256oob": ("<i2", None), "dV3_res256oob": ("<i2", None),
    "dV2_process": ("<i2", (256, 256)), "dV2_res256": ("<i2", (128, 128)),
    "dV2_jpeg": ("<i2", (256, 256)),
    "dU_res256oob_at_malloc": ("<i2", None),
    "dV_res256oob_at_malloc": ("<i2", None),
    "dHT_oob_at_malloc": ("<i2", None),
    "dK_kernel": ("<i2", None),
    "dP0_process": ("<i2", (512, 512)), "dP0_jpeg": ("<i2", (512, 512)),
    "dHQ_whs": ("<i2", None), "dHQ_snap": ("<i2", None),
    "dHQ_synth": ("<i2", None), "dHQ_wfo": ("<i2", None),
    "dHQ_band": ("<i2", None),
    "dS1_oob": ("<i2", None), "dS2_oob": ("<i2", None),
    "dS3_oob": ("<i2", None),
    "d10_process": ("<i2", (512, 512)),
    "d11_process": ("<i2", (512, 512)),
    "d12_imnhw": ("u1", None), "d12_sel1": ("<i4", None),
    "d12_sel2": ("<i4", None),
    "d13u_process": ("<i2", (256, 256)), "d14u_process": ("<i2", (256, 256)),
    "d13v_process": ("<i2", (256, 256)), "d14v_process": ("<i2", (256, 256)),
    "d15_imnhw": ("u1", None), "d15_tree1": ("u1", None),
    "d16_res256": ("<i2", (256, 256)), "d16_process": ("<i2", (512, 512)),
    "d16_oob": ("<i2", None),
    "d17_res256": ("<i2", (256, 256)), "d17_process": ("<i2", (512, 512)),
}


def load(dump_dir: Path) -> dict[str, np.ndarray]:
    out = {}
    for p in sorted(Path(dump_dir).glob("*.bin")):
        name = p.stem
        dt, shape = _DTYPES.get(name, ("u1", None))
        a = np.frombuffer(p.read_bytes(), dtype=dt)
        out[name] = a.reshape(shape) if shape else a
    return out
