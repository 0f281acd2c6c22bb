"""The paper's evaluation workloads: LUBM's 14 queries and BSBM's 12 queries.

BGP cores of the published query sets (Guo et al. 2005 Appendix; BSBM explore
mix), with constants referencing entities the synthetic generators emit.
FILTER/OPTIONAL clauses of the originals do not affect feature extraction or
partitioning (they act after BGP matching) and are omitted, as in the paper's
analysis which operates on triple patterns.
"""
from __future__ import annotations

from repro_torch.kg.query import Query, TriplePattern as T, v, c

TYPE = "rdf:type"


def lubm_queries(u: int = 0, d: int = 0) -> list[Query]:
    """The 14 LUBM queries, parameterized on a university/department instance."""
    dept = f"ub:U{u}_Dept{d}"
    uni = f"ub:University{u}"
    gcourse0 = f"{dept}_GraduateCourse0"
    aprof0 = f"{dept}_AssociateProfessor0"
    return [
        # Q1: graduate students taking a specific graduate course
        Query("LUBM-Q1", (
            T(v("X"), c(TYPE), c("ub:GraduateStudent")),
            T(v("X"), c("ub:takesCourse"), c(gcourse0)),
        )),
        # Q2: triangle — grad students with undergrad degree from the university
        # of their department
        Query("LUBM-Q2", (
            T(v("X"), c(TYPE), c("ub:GraduateStudent")),
            T(v("Y"), c(TYPE), c("ub:University")),
            T(v("Z"), c(TYPE), c("ub:Department")),
            T(v("X"), c("ub:memberOf"), v("Z")),
            T(v("Z"), c("ub:subOrganizationOf"), v("Y")),
            T(v("X"), c("ub:undergraduateDegreeFrom"), v("Y")),
        )),
        # Q3: publications of a particular professor
        Query("LUBM-Q3", (
            T(v("X"), c(TYPE), c("ub:Publication")),
            T(v("X"), c("ub:publicationAuthor"), c(aprof0)),
        )),
        # Q4: professors working for a department, with contact info
        Query("LUBM-Q4", (
            T(v("X"), c(TYPE), c("ub:Professor")),
            T(v("X"), c("ub:worksFor"), c(dept)),
            T(v("X"), c("ub:name"), v("Y1")),
            T(v("X"), c("ub:emailAddress"), v("Y2")),
            T(v("X"), c("ub:telephone"), v("Y3")),
        )),
        # Q5: persons that are members of a department
        Query("LUBM-Q5", (
            T(v("X"), c(TYPE), c("ub:Person")),
            T(v("X"), c("ub:memberOf"), c(dept)),
        )),
        # Q6: all students (single pattern)
        Query("LUBM-Q6", (
            T(v("X"), c(TYPE), c("ub:Student")),
        )),
        # Q7: students taking courses taught by a particular professor
        Query("LUBM-Q7", (
            T(v("X"), c(TYPE), c("ub:Student")),
            T(v("Y"), c(TYPE), c("ub:Course")),
            T(v("X"), c("ub:takesCourse"), v("Y")),
            T(c(aprof0), c("ub:teacherOf"), v("Y")),
        )),
        # Q8: students member of any department of a university, with email
        Query("LUBM-Q8", (
            T(v("X"), c(TYPE), c("ub:Student")),
            T(v("Y"), c(TYPE), c("ub:Department")),
            T(v("X"), c("ub:memberOf"), v("Y")),
            T(v("Y"), c("ub:subOrganizationOf"), c(uni)),
            T(v("X"), c("ub:emailAddress"), v("Z")),
        )),
        # Q9: triangle — students taking a course taught by their advisor
        Query("LUBM-Q9", (
            T(v("X"), c(TYPE), c("ub:Student")),
            T(v("Y"), c(TYPE), c("ub:Faculty")),
            T(v("Z"), c(TYPE), c("ub:Course")),
            T(v("X"), c("ub:advisor"), v("Y")),
            T(v("Y"), c("ub:teacherOf"), v("Z")),
            T(v("X"), c("ub:takesCourse"), v("Z")),
        )),
        # Q10: students taking a specific graduate course
        Query("LUBM-Q10", (
            T(v("X"), c(TYPE), c("ub:Student")),
            T(v("X"), c("ub:takesCourse"), c(gcourse0)),
        )),
        # Q11: research groups of a university (n-hop subOrganizationOf)
        Query("LUBM-Q11", (
            T(v("X"), c(TYPE), c("ub:ResearchGroup")),
            T(v("X"), c("ub:subOrganizationOf"), v("D")),
            T(v("D"), c("ub:subOrganizationOf"), c(uni)),
        )),
        # Q12: chairs heading departments of a university
        Query("LUBM-Q12", (
            T(v("X"), c(TYPE), c("ub:Chair")),
            T(v("Y"), c(TYPE), c("ub:Department")),
            T(v("X"), c("ub:worksFor"), v("Y")),
            T(v("Y"), c("ub:subOrganizationOf"), c(uni)),
            T(v("X"), c("ub:headOf"), v("Y")),
        )),
        # Q13: alumni of a university
        Query("LUBM-Q13", (
            T(v("X"), c(TYPE), c("ub:Person")),
            T(v("X"), c("ub:undergraduateDegreeFrom"), c(uni)),
        )),
        # Q14: all undergraduate students (single pattern)
        Query("LUBM-Q14", (
            T(v("X"), c(TYPE), c("ub:UndergraduateStudent")),
        )),
    ]


def bsbm_queries(prod: int = 0, offer: str = "bsbm:Offer_0_0",
                 review: str = "bsbm:Review_0_0") -> list[Query]:
    """BGP cores of the 12 BSBM explore-mix queries."""
    product = f"bsbm:Product{prod}"
    ptype = "bsbm:ProductType0"
    f1, f2 = "bsbm:ProductFeature0", "bsbm:ProductFeature1"
    return [
        # Q1: products of a type having two features
        Query("BSBM-Q1", (
            T(v("P"), c(TYPE), c(ptype)),
            T(v("P"), c("bsbm:productFeature"), c(f1)),
            T(v("P"), c("bsbm:productFeature"), c(f2)),
            T(v("P"), c("bsbm:productPropertyNumeric1"), v("N")),
        )),
        # Q2: details of a product
        Query("BSBM-Q2", (
            T(c(product), c("rdfs:label"), v("L")),
            T(c(product), c("bsbm:producer"), v("PR")),
            T(v("PR"), c("rdfs:label"), v("PRL")),
            T(c(product), c("bsbm:productFeature"), v("F")),
            T(c(product), c("bsbm:productPropertyTextual1"), v("T1")),
            T(c(product), c("bsbm:productPropertyNumeric1"), v("N1")),
        )),
        # Q3: products of a type with a feature and numeric properties
        Query("BSBM-Q3", (
            T(v("P"), c(TYPE), c(ptype)),
            T(v("P"), c("bsbm:productFeature"), c(f1)),
            T(v("P"), c("bsbm:productPropertyNumeric1"), v("N1")),
            T(v("P"), c("bsbm:productPropertyNumeric2"), v("N2")),
        )),
        # Q4: products of a type with either of two features (BGP core: both legs)
        Query("BSBM-Q4", (
            T(v("P"), c(TYPE), c(ptype)),
            T(v("P"), c("bsbm:productFeature"), c(f2)),
            T(v("P"), c("rdfs:label"), v("L")),
            T(v("P"), c("bsbm:productPropertyNumeric1"), v("N1")),
        )),
        # Q5: products with similar numeric properties to a given product
        Query("BSBM-Q5", (
            T(c(product), c("bsbm:productPropertyNumeric1"), v("N0")),
            T(v("P"), c("bsbm:productPropertyNumeric1"), v("N0")),
            T(v("P"), c(TYPE), c("bsbm:Product")),
            T(v("P"), c("rdfs:label"), v("L")),
        )),
        # Q6: products whose label matches (BGP core)
        Query("BSBM-Q6", (
            T(v("P"), c(TYPE), c("bsbm:Product")),
            T(v("P"), c("rdfs:label"), v("L")),
        )),
        # Q7: product with offers (vendor in country) and reviews
        Query("BSBM-Q7", (
            T(c(product), c("rdfs:label"), v("L")),
            T(v("O"), c("bsbm:offerProduct"), c(product)),
            T(v("O"), c("bsbm:vendor"), v("V")),
            T(v("V"), c("bsbm:country"), c("lit:DE")),
            T(v("O"), c("bsbm:price"), v("PR")),
            T(v("R"), c("bsbm:reviewFor"), c(product)),
            T(v("R"), c("bsbm:reviewer"), v("REV")),
            T(v("R"), c("bsbm:rating1"), v("RT")),
        )),
        # Q8: reviews for a product with reviewer names
        Query("BSBM-Q8", (
            T(v("R"), c("bsbm:reviewFor"), c(product)),
            T(v("R"), c("bsbm:reviewer"), v("REV")),
            T(v("REV"), c("foaf:name"), v("N")),
            T(v("R"), c("bsbm:rating1"), v("RT")),
            T(v("R"), c("bsbm:reviewDate"), v("D")),
        )),
        # Q9: reviewer of a given review
        Query("BSBM-Q9", (
            T(c(review), c("bsbm:reviewer"), v("P")),
            T(v("P"), c("foaf:name"), v("N")),
            T(v("P"), c("bsbm:country"), v("C")),
        )),
        # Q10: cheap offers from US vendors for a product
        Query("BSBM-Q10", (
            T(v("O"), c("bsbm:offerProduct"), c(product)),
            T(v("O"), c("bsbm:vendor"), v("V")),
            T(v("V"), c("bsbm:country"), c("lit:US")),
            T(v("O"), c("bsbm:price"), v("PR")),
            T(v("O"), c("bsbm:deliveryDays"), v("D")),
        )),
        # Q11: all information about an offer
        Query("BSBM-Q11", (
            T(c(offer), c("bsbm:offerProduct"), v("P")),
            T(c(offer), c("bsbm:vendor"), v("V")),
            T(c(offer), c("bsbm:price"), v("PR")),
            T(c(offer), c("bsbm:validTo"), v("VT")),
        )),
        # Q12: export an offer (product + vendor labels)
        Query("BSBM-Q12", (
            T(c(offer), c("bsbm:offerProduct"), v("P")),
            T(v("P"), c("rdfs:label"), v("PL")),
            T(c(offer), c("bsbm:vendor"), v("V")),
            T(v("V"), c("rdfs:label"), v("VL")),
            T(v("V"), c("bsbm:country"), v("C")),
            T(c(offer), c("bsbm:price"), v("PR")),
        )),
    ]
