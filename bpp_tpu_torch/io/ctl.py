"""Copied from ``bpp_tpu/io/ctl.py`` (numpy / pure Python, unchanged but for
its imports and :func:`parse_ctl_text`, which parses the control-file
text a checkpoint carries) so that the PyTorch port never loads that
package.

Inference control-file parser.

Behavioral equivalent of the reference parser (``src/cfile.c``
``load_cfile:2971``): ``keyword = value`` lines, ``#``/``*`` comments,
and the multi-line ``species&tree`` block (``cfile.c:3322``).  Produces
an immutable :class:`bpp_tpu_torch.config.BppConfig`.
"""

from __future__ import annotations

import os
import re

from ..config import (
    BppConfig, Clock, Finetune, Prior, PriorDist, SpeciesTreeSpec, SubstModel,
)


def _strip_comment(line: str) -> str:
    # '#' always starts a comment; '*' starts one at start-of-line or after
    # whitespace (values like 'print = 1 0 0 0 * note' appear in the wild)
    line = line.split("#", 1)[0]
    m = re.search(r"(^|\s)\*", line)
    if m:
        line = line[: m.start()]
    return line.strip()


def _floats(s: str) -> list[float]:
    return [float(t) for t in s.replace(":", " ").split()]


def _parse_prior(value: str, default_dist: PriorDist) -> tuple[Prior, bool]:
    """Parse 'gamma a b', 'invgamma a b [e]', 'beta p q min max' or 'a b [e]'.

    Returns (prior, integrated) where integrated reflects a trailing
    'int' token (theta integrated out analytically); a trailing 'e'/'E'
    means estimate (the default).  cfile.c:453 get_e: 'int' -> 0,
    'e' -> 1, absent -> 1.
    """
    toks = value.split()
    dist = default_dist
    if toks and not _is_number(toks[0]):
        name = toks[0].lower()
        dist = {
            "gamma": PriorDist.GAMMA,
            "invgamma": PriorDist.INVGAMMA,
            "beta": PriorDist.BETA,
            "exp": PriorDist.EXP,
        }.get(name)
        if dist is None:
            raise ValueError(f"unknown prior distribution {toks[0]!r}")
        toks = toks[1:]
    integrated = False
    if toks and toks[-1].lower() == "int":
        integrated = True
        toks = toks[:-1]
    elif toks and toks[-1].lower() == "e":
        toks = toks[:-1]
    nums = [float(t) for t in toks]
    if dist == PriorDist.BETA:
        if len(nums) == 2:
            nums += [0.0, 1.0]
        if len(nums) != 4:
            raise ValueError(f"beta prior expects 'p q [min max]', got {value!r}")
        return Prior(dist, nums[0], nums[1], nums[2], nums[3]), integrated
    if len(nums) < 2:
        raise ValueError(f"prior expects two parameters, got {value!r}")
    return Prior(dist, nums[0], nums[1]), integrated


def _is_number(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False


_MODELS = {m.name: m for m in SubstModel}

# new-style (>=4.8.1) finetune dict keys -> Finetune fields (cfile.c ft_labels)
_FT_KEYS = {
    "gage": "gtage", "gspr": "gtspr", "tau": "tau", "mix": "mix",
    "lrht": "locusrate", "phis": "phi", "pi": "freqs", "qmat": "qrates",
    "alfa": "alpha", "mubr": "mubar", "mu_i": "mui", "brte": "branchrate",
    "theta": "theta", "nubr": "nubar", "nu_i": "nui",
}


def _parse_finetune(value: str) -> Finetune:
    """Both syntaxes: old '1: 5 0.001 ...' positional list and the
    >=4.8.1 dict form '1 Gage:5 Gspr:0.001 mix:0.3' (cfile.c
    parse_finetune)."""
    toks = value.split()
    head = toks[0].rstrip(":")
    auto = bool(int(head))
    rest = value[len(toks[0]):].strip() if toks else ""
    kw: dict = {}
    if toks[0].endswith(":") or (len(toks) > 1 and toks[1] == ":"):
        # old positional syntax: '1: Gage Gspr theta tau mix lrht seqerr'
        nums = [float(t) for t in rest.split() if t != ":"]
        names = ["gtage", "gtspr", "theta", "tau", "mix", "locusrate",
                 "seqerr"]
        kw = dict(zip(names, nums))
    else:
        for tok in toks[1:]:
            if ":" not in tok:
                raise ValueError(f"bad finetune entry {tok!r}")
            key, val = tok.split(":", 1)
            lk = key.lower()
            if lk in _FT_KEYS:
                kw[_FT_KEYS[lk]] = float(val)
            elif lk.startswith(("th", "wr", "wi")):
                # per-parameter step lengths (th1:, wr1:, wi1:) — use as
                # the scalar starting value for the family
                fam = {"th": "theta", "wr": "migrates", "wi": "migrates"}
                kw[fam[lk[:2]]] = float(val)
            else:
                raise ValueError(f"unknown finetune key {key!r}")
    return Finetune(auto=auto, **kw)


def parse_ctl(path: str) -> BppConfig:
    with open(path) as fh:
        text = fh.read()
    # resolve file paths relative to the ctl file's directory, like the C
    # binary run from that directory would
    return parse_ctl_text(text, os.path.dirname(os.path.abspath(path)))


def parse_ctl_text(text: str, base: str) -> BppConfig:
    """A control file's text, its file paths resolved against ``base``
    (the control file's directory; a resumed run takes its text from the
    checkpoint)."""
    cfg = parse_ctl_lines(text.splitlines(True))

    def resolve(p: str | None) -> str | None:
        if p is None or os.path.isabs(p):
            return p
        return os.path.join(base, p)

    return cfg.replace(
        seqfile=resolve(cfg.seqfile),
        imapfile=resolve(cfg.imapfile),
        datefile=resolve(cfg.datefile),
        constraintfile=resolve(cfg.constraintfile),
        heredity_file=resolve(cfg.heredity_file),
        locusrate_file=resolve(cfg.locusrate_file),
        traitfile=resolve(cfg.traitfile),
        partition_file=resolve(cfg.partition_file),
    )


def parse_ctl_string(text: str) -> BppConfig:
    return parse_ctl_lines(text.splitlines(True))


def parse_ctl_lines(lines: list[str]) -> BppConfig:  # noqa: C901
    kw: dict = {}
    i = 0
    n = len(lines)

    def next_content_line(j: int) -> tuple[str, int]:
        while j < n:
            s = _strip_comment(lines[j])
            j += 1
            if s:
                return s, j
        raise ValueError("unexpected end of control file in species&tree block")

    while i < n:
        raw = _strip_comment(lines[i])
        i += 1
        if not raw or "=" not in raw:
            continue
        key, value = raw.split("=", 1)
        key = key.strip().lower()
        value = value.strip()

        if key == "species&tree":
            toks = value.split()
            count = int(toks[0])
            names = tuple(toks[1:])
            if len(names) != count:
                raise ValueError(
                    f"species&tree: expected {count} names, got {len(names)}")
            line, i = next_content_line(i)
            maxseqs = tuple(int(t) for t in line.split())
            if len(maxseqs) != count:
                raise ValueError(
                    f"species&tree: expected {count} max-seq counts")
            newick = None
            if count > 1:
                chunks = []
                while True:
                    line, i = next_content_line(i)
                    chunks.append(line)
                    if ";" in line:
                        break
                newick = " ".join(chunks)
            kw["species"] = SpeciesTreeSpec(count, names, maxseqs, newick)
        elif key == "migration":
            # cfile.c:2289: 'migration = K' then K route lines
            count = int(value.split()[0])
            specs = []
            for _ in range(count):
                line, i = next_content_line(i)
                toks = line.replace(",", " ").split()
                src, dst = toks[0], toks[1]
                nums = [float(t) for t in toks[2:]]
                s = {"source": src, "target": dst}
                if len(nums) == 1:
                    s["am"] = nums[0]
                elif len(nums) >= 2:
                    s["alpha"], s["beta"] = nums[0], nums[1]
                if len(nums) in (3, 5):
                    s["am"] = nums[2]
                if len(nums) == 4:
                    s["pseudo_a"], s["pseudo_b"] = nums[2], nums[3]
                elif len(nums) == 5:
                    s["pseudo_a"], s["pseudo_b"] = nums[3], nums[4]
                from ..config import MigSpec
                specs.append(MigSpec(**s))
            kw["__migration__"] = tuple(specs)
        else:
            kw[key] = value

    return _build_config(kw)


def _build_config(kw: dict) -> BppConfig:  # noqa: C901
    c: dict = {}

    def pop(key, default=None):
        return kw.pop(key, default)

    if "species" in kw:
        c["species"] = kw.pop("species")

    for src, dst in [("seqfile", "seqfile"), ("imapfile", "imapfile"),
                     ("jobname", "jobname"), ("outfile", "jobname"),
                     ("mcmcfile", "mcmcfile"), ("datefile", "datefile"),
                     ("constraintfile", "constraintfile"),
                     ("traitfile", "traitfile")]:
        v = pop(src)
        if v is not None:
            c[dst] = v

    v = pop("speciesdelimitation")
    if v is not None:
        toks = v.split()
        if int(toks[0]) == 1:
            c["est_delimit"] = True
            alg = int(toks[1]) if len(toks) > 1 else 0
            c["rjmcmc_method"] = alg
            if alg == 0 and len(toks) > 2:
                c["rjmcmc_epsilon"] = float(toks[2])
            elif alg == 1 and len(toks) > 3:
                c["rjmcmc_alpha"] = float(toks[2])
                c["rjmcmc_mean"] = float(toks[3])

    v = pop("speciestree")
    if v is not None:
        toks = v.split()
        if int(toks[0]) == 1:
            c["est_stree"] = True
            nums = [float(t) for t in toks[1:]]
            # cfile.c:502 parse_speciestree: pSNL pShrink lamExpand lamShrink
            if len(nums) > 0:
                c["prob_snl"] = nums[0]
            if len(nums) > 1:
                c["prob_snl_shrink"] = nums[1]
            if len(nums) > 2:
                c["snl_lambda_expand"] = nums[2]
            if len(nums) > 3:
                c["snl_lambda_shrink"] = nums[3]

    v = pop("speciesmodelprior")
    if v is not None:
        c["delimit_prior"] = int(v)

    v = pop("phase")
    if v is not None:
        c["phase"] = tuple(int(t) for t in v.split())

    v = pop("usedata")
    if v is not None:
        # cfile.c:3127-3135: 0 = prior only, 1 = with data, 2 = fix
        # gene trees at their MSC-prior init (likelihood off)
        u = int(v.split()[0])
        if u not in (0, 1, 2):
            raise ValueError("usedata expects 0, 1 or 2")
        c["usedata"] = u == 1
        c["usedata_fix_gtree"] = u == 2

    for key, conv in [("cleandata", lambda s: bool(int(s))),
                      ("nloci", int), ("seed", lambda s: int(float(s))),
                      ("burnin", int), ("sampfreq", int), ("nsample", int),
                      ("scaling", lambda s: bool(int(s)))]:
        v = pop(key)
        if v is not None:
            c[key] = conv(v.split()[0])

    v = pop("model")
    if v is not None:
        toks = v.split()
        name = toks[0].upper()
        if name == "CUSTOM":
            # model = custom <partition_file> (cfile.c:1374)
            if len(toks) < 2:
                raise ValueError("model = custom requires a partition file")
            c["model"] = SubstModel.CUSTOM
            c["partition_file"] = toks[1]
        elif name.isdigit():
            c["model"] = SubstModel(int(name))
        elif name in _MODELS:
            c["model"] = _MODELS[name]
        else:
            raise ValueError(f"unsupported substitution model {name!r}")

    v = pop("thetaprior")
    if v is not None:
        prior, integ = _parse_prior(v, PriorDist.INVGAMMA)
        c["thetaprior"] = prior
        c["theta_integrated"] = integ

    v = pop("tauprior")
    if v is not None:
        prior, _ = _parse_prior(v, PriorDist.INVGAMMA)
        c["tauprior"] = prior

    v = pop("phiprior")
    if v is not None:
        toks = v.split()
        nums = [float(t) for t in toks if _is_number(t)]
        c["phiprior"] = Prior(PriorDist.BETA, nums[0], nums[1])

    v = pop("alphaprior")
    if v is not None:
        nums = _floats(v)
        c["alphaprior"] = Prior(PriorDist.GAMMA, nums[0], nums[1])
        # ncatG defaults to 4 when alphaprior is given (cfile.c:1444)
        c["alpha_cats"] = int(nums[2]) if len(nums) > 2 else 4

    v = pop("clock")
    if v is not None:
        # clock = 1 | 4 alpha | 2/3 a_vbar b_vbar a_vi [prior [dist]]
        # (cfile.c:814 parse_clock)
        toks = v.split()
        c["clock"] = Clock(int(toks[0]))
        nums = [float(t) for t in toks[1:] if _is_number(t)]
        words = [t.lower() for t in toks[1:] if not _is_number(t)]
        if c["clock"] == Clock.SIMPLE:
            if nums:
                c["clock_alpha"] = nums[0]
        elif c["clock"] in (Clock.IID, Clock.CORRELATED):
            if len(nums) < 3:
                raise ValueError(
                    "clock = 2/3 requires 'a_vbar b_vbar a_vi'")
            c["clock_vbar_a"], c["clock_vbar_b"] = nums[0], nums[1]
            c["clock_vi_alpha"] = nums[2]
            prior_names = {"gamma-dirichlet": 0, "gdir": 0, "dir": 3,
                           "hierarchical": 1, "iid": 1, "none": 2}
            dist_names = {"ln": 0, "lognormal": 0, "g": 1, "gamma": 1}
            # shared opt_locusrate_prior: 'locusrate' takes precedence
            # (the reference fatals on mismatch, cfile.c:891-911)
            if words and "locusrate_prior" not in c:
                c["locusrate_prior"] = prior_names.get(words[0], 0)
            if len(words) > 1:
                c["clock_rate_prior"] = dist_names.get(words[1], 1)

    v = pop("locusrate")
    if v is not None:
        # locusrate = 1 a_mubar b_mubar a_mui [prior]   (cfile.c:951;
        # pre-4.1.4 two-number form '1 a_mui' also accepted)
        toks = v.split()
        c["est_locusrate"] = int(toks[0])
        nums = [float(t) for t in toks[1:] if _is_number(t)]
        words = [t.lower() for t in toks[1:] if not _is_number(t)]
        if c["est_locusrate"] == 1:
            if len(nums) >= 3:
                c["locusrate_mubar_a"], c["locusrate_mubar_b"] = nums[0], nums[1]
                c["locusrate_alpha"] = nums[2]
            elif len(nums) == 1:
                c["locusrate_alpha"] = nums[0]
            prior_names = {"gamma-dirichlet": 0, "gdir": 0, "hierarchical": 1,
                           "iid": 1, "none": 2, "dir": 3}
            if words:
                c["locusrate_prior"] = prior_names.get(words[0], 0)
            if len(nums) >= 4:
                c["locusrate_prior"] = int(nums[3])
            # GammaDir with a_mubar = b_mubar = 0 degrades to the fixed-
            # mubar Dirichlet prior (cfile.c:2893-2897)
            if (c.get("locusrate_prior", 0) == 0
                    and c.get("locusrate_mubar_a", 0.0) == 0
                    and c.get("locusrate_mubar_b", 0.0) == 0):
                c["locusrate_prior"] = 3
        elif c["est_locusrate"] == 3:
            # locusrate = 3 a_mubar b_mubar  (MUTRATE_ONLY, tip dating;
            # cfile.c:1058-1076)
            if len(nums) >= 2:
                c["locusrate_mubar_a"] = nums[0]
                c["locusrate_mubar_b"] = nums[1]
        elif c["est_locusrate"] == 2:
            # locusrate = 2 filename  (MUTRATE_FROMFILE, cfile.c:1051)
            rest = v.split(None, 1)[1].strip() if len(toks) > 1 else ""
            if rest and not _is_number(rest):
                c["locusrate_file"] = rest
            elif nums:
                c["locusrate_mubar"] = nums[0]

    v = pop("thetamodel")
    if v is not None:
        names = {"linked-none": 0, "linked-all": 1, "linked-inner": 2,
                 "linked-msci": 3, "linked-mscm": 4}
        w = v.split()[0].lower()
        if w not in names:
            raise ValueError(f"unknown thetamodel {w!r} (cfile.c:1460)")
        c["linked_theta"] = names[w]

    v = pop("printlocus")
    if v is not None:
        toks = v.split()
        c["print_locus"] = tuple(int(t) for t in toks[1:1 + int(toks[0])])

    if "diploid" in kw:
        raise ValueError("Option 'diploid' was renamed to 'phase' (same "
                         "syntax); please update the control file")
    for ignored in ("arch", "threads", "loadbalance"):
        # CPU execution knobs; the TPU build parallelizes via device
        # mesh sharding instead (SURVEY.md section 2.4)
        kw.pop(ignored, None)

    v = pop("heredity")
    if v is not None:
        toks = v.split()
        c["est_heredity"] = int(toks[0])
        if c["est_heredity"] == 2 and len(toks) > 1:
            # heredity = 2 filename (HEREDITY_FROMFILE, method.c:3938)
            c["heredity_file"] = toks[1]
        elif len(toks) > 2:
            c["heredity_alpha"] = float(toks[1])
            c["heredity_beta"] = float(toks[2])

    v = pop("finetune")
    if v is not None:
        c["finetune"] = _parse_finetune(v)

    v = pop("print")
    if v is not None:
        nums = [int(t) for t in v.split()]
        for name, val in zip(["print_samples", "print_locusrate",
                              "print_hscalars", "print_genetrees",
                              "print_rates"], nums):
            c[name] = val

    v = pop("threads")
    if v is not None:
        nums = [int(t) for t in v.split()]
        while len(nums) < 3:
            nums.append([1, 0, 1][len(nums)] if len(nums) else 1)
        c["threads"] = tuple(nums[:3])

    v = pop("checkpoint")
    if v is not None:
        nums = [int(t) for t in v.split()]
        c["checkpoint"] = (nums[0], nums[1] if len(nums) > 1 else 0)

    v = pop("check")
    if v is not None:
        toks = v.split()
        c["check_every"] = int(toks[0])
        if len(toks) > 1:
            c["check_tol"] = float(toks[1])

    v = pop("chains")
    if v is not None:
        c["n_chains"] = int(v.split()[0])
        if c["n_chains"] < 1:
            raise ValueError("chains must be >= 1")

    v = pop("bayesfactorbeta")
    if v is not None:
        c["bfbeta"] = float(v.split()[0])

    v = pop("geneflow")
    if v is not None:
        c["geneflow"] = bool(int(v.split()[0]))
        if c["geneflow"]:
            # geneflow implies the migration machinery even without an
            # explicit migration block (method.c:5660 asserts
            # opt_migration under opt_est_geneflow); the route set
            # starts at the configured routes (possibly none)
            c["migration"] = True

    v = pop("__migration__")
    if v is not None:
        c["mig_specs"] = v
        c["migration"] = len(v) > 0

    v = pop("migprior")
    if v is not None:
        prior, _ = _parse_prior(v, PriorDist.GAMMA)
        c["migprior"] = prior

    v = pop("wprior")
    if v is not None:
        prior, _ = _parse_prior(v, PriorDist.GAMMA)
        c["wprior"] = prior

    # silently accept-and-record unknown keywords for forward compat
    cfg = BppConfig(**c)
    if kw:
        unknown = ", ".join(sorted(kw))
        import warnings
        warnings.warn(f"ignoring unsupported control-file option(s): {unknown}")
    return cfg
