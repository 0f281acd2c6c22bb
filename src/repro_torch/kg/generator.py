"""Deterministic LUBM-like and BSBM-like synthetic knowledge-graph generators.

Statistically shaped after the published benchmark generators (Guo et al. 2005
for LUBM; Bizer & Schultz 2008 for BSBM): same class/predicate schema, same
entity relationships and comparable cardinality ratios, scaled by parameters so
tests can run micro instances on CPU. Superclass types that the published
queries rely on (Student, Faculty, Professor, Person, Chair) are materialized,
matching a store with RDFS inference enabled — the standard way LUBM's queries
are made answerable by a plain SPARQL engine.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kg.triples import TripleStore

# ---------------------------------------------------------------------------
# LUBM-like
# ---------------------------------------------------------------------------

LUBM_PREDICATES = [
    "rdf:type", "ub:worksFor", "ub:memberOf", "ub:subOrganizationOf",
    "ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom", "ub:doctoralDegreeFrom",
    "ub:takesCourse", "ub:teacherOf", "ub:advisor", "ub:publicationAuthor",
    "ub:headOf", "ub:name", "ub:emailAddress", "ub:telephone",
    "ub:researchInterest", "ub:teachingAssistantOf",
]


def generate_lubm(n_universities: int = 1, *, scale: float = 1.0, seed: int = 0,
                  ) -> TripleStore:
    """LUBM-like dataset. scale≈1.0 gives ~100-130k triples per university."""
    rng = np.random.default_rng(seed)
    t: list[tuple[str, str, str]] = []
    add = t.append

    def k(lo: int, hi: int) -> int:
        v = int(round(rng.integers(lo, hi + 1) * scale))
        return max(1, v)

    unis = [f"ub:University{u}" for u in range(max(2, n_universities + 2))]
    for uname in unis:
        add((uname, "rdf:type", "ub:University"))

    for u in range(n_universities):
        uni = unis[u]
        n_dept = k(12, 18)
        for d in range(n_dept):
            dept = f"ub:U{u}_Dept{d}"
            add((dept, "rdf:type", "ub:Department"))
            add((dept, "ub:subOrganizationOf", uni))

            n_rg = k(10, 15)
            for g in range(n_rg):
                rgrp = f"{dept}_Group{g}"
                add((rgrp, "rdf:type", "ub:ResearchGroup"))
                add((rgrp, "ub:subOrganizationOf", dept))

            # --- courses ---------------------------------------------------
            n_course = k(25, 35)
            n_gcourse = k(15, 25)
            courses = [f"{dept}_Course{i}" for i in range(n_course)]
            gcourses = [f"{dept}_GraduateCourse{i}" for i in range(n_gcourse)]
            for cn in courses:
                add((cn, "rdf:type", "ub:Course"))
            for cn in gcourses:
                add((cn, "rdf:type", "ub:GraduateCourse"))
                add((cn, "rdf:type", "ub:Course"))  # materialized superclass

            # --- faculty ---------------------------------------------------
            fac_specs = [("FullProfessor", k(7, 10)), ("AssociateProfessor", k(10, 14)),
                         ("AssistantProfessor", k(8, 11)), ("Lecturer", k(5, 7))]
            faculty: list[str] = []
            professors: list[str] = []
            for cls, n in fac_specs:
                for i in range(n):
                    f = f"{dept}_{cls}{i}"
                    faculty.append(f)
                    add((f, "rdf:type", f"ub:{cls}"))
                    if cls != "Lecturer":
                        professors.append(f)
                        add((f, "rdf:type", "ub:Professor"))
                    add((f, "rdf:type", "ub:Faculty"))
                    add((f, "rdf:type", "ub:Person"))
                    add((f, "ub:worksFor", dept))
                    add((f, "ub:memberOf", dept))
                    add((f, "ub:undergraduateDegreeFrom", unis[rng.integers(len(unis))]))
                    add((f, "ub:mastersDegreeFrom", unis[rng.integers(len(unis))]))
                    add((f, "ub:doctoralDegreeFrom", unis[rng.integers(len(unis))]))
                    add((f, "ub:name", f"lit:name_{f}"))
                    add((f, "ub:emailAddress", f"lit:email_{f}"))
                    add((f, "ub:telephone", f"lit:tel_{f}"))
                    add((f, "ub:researchInterest", f"lit:research{rng.integers(30)}"))
            # department head is a full professor

            head = f"{dept}_FullProfessor0"
            add((head, "ub:headOf", dept))
            add((head, "rdf:type", "ub:Chair"))

            # teaching assignments: every course gets one teacher
            for cn in courses:
                add((faculty[rng.integers(len(faculty))], "ub:teacherOf", cn))
            for cn in gcourses:
                add((professors[rng.integers(len(professors))], "ub:teacherOf", cn))

            # publications
            for f in faculty:
                for pub_i in range(int(rng.integers(3, 8))):
                    pub = f"{f}_Pub{pub_i}"
                    add((pub, "rdf:type", "ub:Publication"))
                    add((pub, "ub:publicationAuthor", f))

            # --- students --------------------------------------------------
            n_under = int(len(faculty) * rng.uniform(8, 12))
            n_grad = int(len(faculty) * rng.uniform(3, 4))
            for i in range(n_under):
                s = f"{dept}_UndergraduateStudent{i}"
                add((s, "rdf:type", "ub:UndergraduateStudent"))
                add((s, "rdf:type", "ub:Student"))
                add((s, "rdf:type", "ub:Person"))
                add((s, "ub:memberOf", dept))
                add((s, "ub:name", f"lit:name_{s}"))
                add((s, "ub:emailAddress", f"lit:email_{s}"))
                add((s, "ub:telephone", f"lit:tel_{s}"))
                for cn in rng.choice(n_course, size=min(n_course, int(rng.integers(2, 5))),
                                     replace=False):
                    add((s, "ub:takesCourse", courses[cn]))
                if rng.uniform() < 0.2:
                    add((s, "ub:advisor", professors[rng.integers(len(professors))]))
            for i in range(n_grad):
                s = f"{dept}_GraduateStudent{i}"
                add((s, "rdf:type", "ub:GraduateStudent"))
                add((s, "rdf:type", "ub:Student"))
                add((s, "rdf:type", "ub:Person"))
                add((s, "ub:memberOf", dept))
                add((s, "ub:name", f"lit:name_{s}"))
                add((s, "ub:emailAddress", f"lit:email_{s}"))
                add((s, "ub:telephone", f"lit:tel_{s}"))
                add((s, "ub:undergraduateDegreeFrom", unis[rng.integers(len(unis))]))
                add((s, "ub:advisor", professors[rng.integers(len(professors))]))
                for cn in rng.choice(n_gcourse, size=min(n_gcourse, int(rng.integers(1, 4))),
                                     replace=False):
                    add((s, "ub:takesCourse", gcourses[cn]))
                if rng.uniform() < 0.2:
                    add((s, "ub:teachingAssistantOf", courses[rng.integers(n_course)]))

    return TripleStore.from_string_triples(t)


# ---------------------------------------------------------------------------
# BSBM-like
# ---------------------------------------------------------------------------

BSBM_PREDICATES = [
    "rdf:type", "bsbm:producer", "bsbm:productFeature", "bsbm:productPropertyNumeric1",
    "bsbm:productPropertyNumeric2", "bsbm:productPropertyTextual1", "rdfs:label",
    "bsbm:vendor", "bsbm:offerProduct", "bsbm:price", "bsbm:deliveryDays",
    "bsbm:validTo", "bsbm:reviewFor", "bsbm:reviewer", "bsbm:rating1", "bsbm:rating2",
    "bsbm:reviewDate", "bsbm:country", "foaf:name",
]

BSBM_COUNTRIES = ["lit:US", "lit:DE", "lit:GB", "lit:JP", "lit:CN", "lit:RU"]


def generate_bsbm(n_products: int = 200, *, seed: int = 0) -> TripleStore:
    """BSBM-like dataset. n_products=1000 gives ~375k-comparable shape (scaled)."""
    rng = np.random.default_rng(seed)
    t: list[tuple[str, str, str]] = []
    add = t.append

    n_ptypes = max(3, n_products // 40)
    n_features = max(8, n_products // 8)
    n_producers = max(3, n_products // 30)
    n_vendors = max(4, n_products // 25)
    n_persons = max(10, n_products // 2)

    ptypes = [f"bsbm:ProductType{i}" for i in range(n_ptypes)]
    features = [f"bsbm:ProductFeature{i}" for i in range(n_features)]
    producers = [f"bsbm:Producer{i}" for i in range(n_producers)]
    vendors = [f"bsbm:Vendor{i}" for i in range(n_vendors)]
    persons = [f"bsbm:Person{i}" for i in range(n_persons)]

    for x in ptypes:
        add((x, "rdf:type", "bsbm:ProductType"))
    for x in features:
        add((x, "rdf:type", "bsbm:ProductFeature"))
    for x in producers:
        add((x, "rdf:type", "bsbm:Producer"))
        add((x, "rdfs:label", f"lit:label_{x}"))
    for x in vendors:
        add((x, "rdf:type", "bsbm:Vendor"))
        add((x, "rdfs:label", f"lit:label_{x}"))
        add((x, "bsbm:country", BSBM_COUNTRIES[rng.integers(len(BSBM_COUNTRIES))]))
    for x in persons:
        add((x, "rdf:type", "foaf:Person"))
        add((x, "foaf:name", f"lit:name_{x}"))
        add((x, "bsbm:country", BSBM_COUNTRIES[rng.integers(len(BSBM_COUNTRIES))]))

    for i in range(n_products):
        prod = f"bsbm:Product{i}"
        add((prod, "rdf:type", "bsbm:Product"))
        add((prod, "rdf:type", ptypes[rng.integers(n_ptypes)]))
        add((prod, "bsbm:producer", producers[rng.integers(n_producers)]))
        add((prod, "rdfs:label", f"lit:label_{prod}"))
        for f in rng.choice(n_features, size=int(rng.integers(3, 8)), replace=False):
            add((prod, "bsbm:productFeature", features[f]))
        add((prod, "bsbm:productPropertyNumeric1", f"lit:num{rng.integers(500)}"))
        add((prod, "bsbm:productPropertyNumeric2", f"lit:num{rng.integers(500)}"))
        add((prod, "bsbm:productPropertyTextual1", f"lit:text{rng.integers(200)}"))

        for oi in range(int(rng.integers(2, 6))):  # offers per product
            offer = f"bsbm:Offer_{i}_{oi}"
            add((offer, "rdf:type", "bsbm:Offer"))
            add((offer, "bsbm:offerProduct", prod))
            add((offer, "bsbm:vendor", vendors[rng.integers(n_vendors)]))
            add((offer, "bsbm:price", f"lit:price{rng.integers(5000)}"))
            add((offer, "bsbm:deliveryDays", f"lit:days{rng.integers(1, 14)}"))
            add((offer, "bsbm:validTo", f"lit:date{rng.integers(365)}"))

        for ri in range(int(rng.integers(1, 6))):  # reviews per product
            rev = f"bsbm:Review_{i}_{ri}"
            add((rev, "rdf:type", "bsbm:Review"))
            add((rev, "bsbm:reviewFor", prod))
            add((rev, "bsbm:reviewer", persons[rng.integers(n_persons)]))
            add((rev, "bsbm:rating1", f"lit:r{rng.integers(1, 11)}"))
            add((rev, "bsbm:rating2", f"lit:r{rng.integers(1, 11)}"))
            add((rev, "bsbm:reviewDate", f"lit:date{rng.integers(365)}"))

    return TripleStore.from_string_triples(t)
